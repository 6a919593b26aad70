"""whisper_tpu_torch.evaluation against whisper_tpu.evaluation.

The cases of tests/test_evaluation.py against the port, and on the same
references and hypotheses both packages' edit distances, WER and CER are
equal (exact: integer counts over the same normalized strings).
``evaluate_batched`` and ``int8_wer_gate`` run end to end on tiny random
weights on the CPU.
"""

import numpy as np
import pytest
import torch

import whisper_tpu.evaluation as jev

from whisper_tpu_torch.evaluation import (
    INT8_WER_GATE_MAX_DELTA,
    ErrorRate,
    char_error_rate,
    edit_distance,
    evaluate_batched,
    int8_divergence_proxy,
    int8_wer_gate,
    word_error_rate,
)

torch.set_num_threads(2)


def test_edit_distance():
    assert edit_distance("kitten", "sitting") == 3
    assert edit_distance([], []) == 0
    assert edit_distance(["a", "b"], ["a", "b"]) == 0
    assert edit_distance(["a"], []) == 1


def test_word_error_rate():
    refs = ["the quick brown fox", "hello world"]
    hyps = ["the quick brown fox", "hello there world"]
    # 1 insertion over 6 reference words
    assert abs(word_error_rate(refs, hyps, normalizer=str.lower) - 1 / 6) < 1e-9


def test_wer_with_normalizer():
    # the normalizer folds case, punctuation and numbers
    refs = ["Mr. Smith paid $20 million!"]
    hyps = ["mister smith paid twenty million dollars"]
    assert word_error_rate(refs, hyps) == 0.0


def test_cer():
    assert char_error_rate(["abc"], ["abc"], normalizer=str.lower) == 0.0
    assert char_error_rate(["abcd"], ["abed"], normalizer=str.lower) == 0.25


def _corpus(seed: int):
    """Reference and hypothesis sentences: words, numbers, contractions and
    spellings the normalizer rewrites, with words dropped, swapped and added."""
    rng = np.random.RandomState(seed)
    vocab = ["the", "colour", "Mr.", "twenty", "one", "$5", "it's", "organisation", "Hello,",
             "world!", "three", "point", "two", "percent", "won't", "10km", "Dr.", "naïve"]
    refs, hyps = [], []
    for _ in range(12):
        ref = list(rng.choice(vocab, rng.randint(0, 12)))
        hyp = [w for w in ref if rng.rand() > 0.2]
        hyp = [str(rng.choice(vocab)) if rng.rand() < 0.15 else w for w in hyp]
        hyp += list(rng.choice(vocab, rng.randint(0, 3)))
        refs.append(" ".join(ref))
        hyps.append(" ".join(hyp))
    return refs, hyps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_error_rates_equal_whisper_tpu(seed):
    refs, hyps = _corpus(seed)
    assert word_error_rate(refs, hyps) == jev.word_error_rate(refs, hyps)
    assert char_error_rate(refs, hyps) == jev.char_error_rate(refs, hyps)
    assert word_error_rate(refs, hyps, str.lower) == jev.word_error_rate(refs, hyps, str.lower)
    for r, h in zip(refs, hyps):
        assert edit_distance(r.split(), h.split()) == jev.edit_distance(r.split(), h.split())
    ours, theirs = ErrorRate(), jev.ErrorRate()
    for r, h in zip(refs, hyps):
        ours.update(list(r), list(h))
        theirs.update(list(r), list(h))
    assert (ours.errors, ours.total, ours.rate) == (theirs.errors, theirs.total, theirs.rate)
    assert INT8_WER_GATE_MAX_DELTA == jev.INT8_WER_GATE_MAX_DELTA


@pytest.fixture(scope="module")
def models():
    from whisper_tpu_torch.models.dims import ModelDimensions
    from whisper_tpu_torch.models.whisper import Whisper, init_params
    from whisper_tpu_torch.quantize import quantize_params

    dims = ModelDimensions(
        n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
        n_vocab=51865, n_text_ctx=448, n_text_state=128, n_text_head=2, n_text_layer=2,
    )
    params = init_params(dims, torch.Generator().manual_seed(0), torch.float32)
    return Whisper(dims, params), Whisper(dims, quantize_params(params))


def test_evaluate_batched(models):
    """Three utterances in batches of two: a report of whisper_tpu's keys,
    the hypotheses of transcribe_batch on the same audio and options."""
    from whisper_tpu_torch.batch import transcribe_batch

    model, _ = models
    rng = np.random.RandomState(0)
    items = [(rng.randn(16000 * n).astype(np.float32) * 0.1, "hello world") for n in (2, 5, 3)]
    report = evaluate_batched(model, items, batch_size=2, sample_len=4)
    assert set(report) == {"wer", "cer", "n_utterances", "audio_seconds", "decode_seconds", "rtf",
                           "hypotheses"}
    assert report["n_utterances"] == 3 and report["audio_seconds"] == 10.0
    assert np.isfinite(report["wer"]) and report["rtf"] > 0
    direct = transcribe_batch(model, [a for a, _ in items], batch_size=2, language="en",
                              without_timestamps=True, temperature=0.0,
                              condition_on_previous_text=False, compression_ratio_threshold=None,
                              logprob_threshold=None, no_speech_threshold=None, sample_len=4)
    assert report["hypotheses"] == [r["text"].strip() for r in direct]
    assert report["wer"] == word_error_rate(["hello world"] * 3, report["hypotheses"])


def test_int8_wer_gate_and_divergence_proxy(models):
    """tests/test_evaluation.py's case against the port: identical models
    pass the gate with no divergence; the int8 model's statistics are
    finite and show the quantization."""
    model, qmodel = models
    rng = np.random.RandomState(0)
    items = [(rng.randn(16000 * 2).astype(np.float32) * 0.1, "hello world") for _ in range(3)]

    same = int8_wer_gate(model, model, items, batch_size=2, sample_len=4)
    assert same["delta"] == 0.0 and same["passed"]
    assert 0 < INT8_WER_GATE_MAX_DELTA < 0.01

    gate = int8_wer_gate(model, qmodel, items, batch_size=2, sample_len=4)
    assert set(gate) >= {"bf16_wer", "int8_wer", "delta", "passed"}
    assert np.isfinite(gate["delta"])
    reused = int8_wer_gate(model, qmodel, items, batch_size=2, sample_len=4,
                           bf16_report={"wer": gate["bf16_wer"], "n_utterances": 3})
    assert reused["delta"] == gate["delta"]

    mels = rng.randn(2, 80, 3000).astype(np.float32) * 0.3
    prox_same = int8_divergence_proxy(model, model, mels, sample_len=4)
    assert prox_same["token_agreement"] == 1.0
    assert prox_same["logit_absdiff_max"] == 0.0
    assert prox_same["top1_match"] == 1.0
    prox = int8_divergence_proxy(model, qmodel, mels, sample_len=4)
    assert 0.0 <= prox["token_agreement"] <= 1.0
    assert prox["logit_absdiff_max"] > 0.0
    assert np.isfinite(prox["logit_absdiff_mean"])
    assert prox["n_windows"] == 2
