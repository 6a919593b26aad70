"""whisper_tpu_torch.distill against whisper_tpu.distill on the CPU.

The same teacher weights in both packages (whisper_tpu's init_params
through params_from_numpy) at tests/test_distill.py's dims, the same mels
from a numpy seed; the pseudo-labels are the port's own greedy decode of
them, given to both packages as the same tokens.  Every case of
tests/test_distill.py runs against the port, then:

- ``init_draft_from_teacher``: the student's leaves equal whisper_tpu's
  bit for bit;
- ``distill_loss`` (with and without the CE term) and one ``distill_step``
  on the same one-layer student: the loss within 1e-5 relative plus 1e-6
  (the KL sums p x (log p - log q) over the vocabulary, each log-probability
  near -11, where one f32 rounding is about 1e-6), grad_norm within 1e-4
  relative;
- ``offline_acceptance``: equal (an argmax count on the same logits to
  within rounding);
- tests/test_parallel.py's distill-step case on one device: the loss falls
  in three steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.distill as jdistill
import whisper_tpu.training as jt
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.whisper import Whisper as JWhisper
from whisper_tpu.models.whisper import init_params as j_init_params

import whisper_tpu_torch
import whisper_tpu_torch.distill as td
from whisper_tpu_torch.decoding import DecodingOptions
from whisper_tpu_torch.distill import (
    DistillState,
    distill,
    distill_loss,
    distill_step,
    init_draft_from_teacher,
    make_draft_dims,
    offline_acceptance,
)
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.load import params_from_numpy
from whisper_tpu_torch.models.whisper import Whisper, encoder_apply
from whisper_tpu_torch.tokenizer import get_tokenizer
from whisper_tpu_torch.training import make_optimizer

torch.set_num_threads(2)

KW = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
          n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=3)
DIMS, JD = ModelDimensions(**KW), JDims(**KW)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jteacher():
    return JWhisper(JD, j_init_params(JD, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def teacher(jteacher):
    return Whisper(DIMS, params_from_numpy(_np(jteacher.params), DIMS))


@pytest.fixture(scope="module")
def mels():
    rng = np.random.RandomState(5)
    return torch.from_numpy((rng.randn(4, 80, 3000) * 0.4).astype(np.float32))


@pytest.fixture(scope="module")
def pseudo_batch(teacher, mels):
    """Teacher greedy transcripts as a teacher-forced distillation batch,
    the features from embed_audio (inference tensors)."""
    opts = DecodingOptions(language="en", temperature=0.0, sample_len=16, without_timestamps=True)
    results = whisper_tpu_torch.decode(teacher, mels, opts)
    tok = get_tokenizer(multilingual=True, language="en", task="transcribe")
    prefix = list(tok.sot_sequence_including_notimestamps)
    seqs = [prefix + list(r.tokens) + [tok.eot] for r in results]
    S = max(len(s) for s in seqs)
    tokens = np.full((len(seqs), S), tok.eot, np.int32)
    mask = np.zeros((len(seqs), S), np.float32)
    for i, s in enumerate(seqs):
        tokens[i, : len(s)] = s
        mask[i, len(prefix): len(s)] = 1.0  # predict text tokens + EOT
    features = teacher.embed_audio(mels)
    assert features.is_inference()
    return {"features": features, "tokens": torch.from_numpy(tokens),
            "loss_mask": torch.from_numpy(mask)}


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def test_draft_dims_and_init(teacher, jteacher):
    draft_params, draft_dims = init_draft_from_teacher(teacher.params, DIMS, n_text_layer=2)
    assert draft_dims == dataclasses.replace(DIMS, n_text_layer=2)
    # maximally spaced init: first and last teacher layers
    leaf = teacher.params["decoder"]["blocks"]["fc1_w"]
    draft_leaf = draft_params["decoder"]["blocks"]["fc1_w"]
    assert draft_leaf.shape[0] == 2
    torch.testing.assert_close(draft_leaf[0], leaf[0], rtol=0, atol=0)
    torch.testing.assert_close(draft_leaf[1], leaf[DIMS.n_text_layer - 1], rtol=0, atol=0)
    # embeddings / final LN are the teacher's values in tensors of their own
    tok_emb = teacher.params["decoder"]["tok_emb"]
    torch.testing.assert_close(draft_params["decoder"]["tok_emb"], tok_emb, rtol=0, atol=0)
    before = tok_emb.clone()
    draft_params["decoder"]["tok_emb"].add_(1.0)
    draft_params["decoder"]["ln_g"].add_(1.0)
    draft_leaf.add_(1.0)
    torch.testing.assert_close(tok_emb, before, rtol=0, atol=0)
    assert bool((teacher.params["decoder"]["ln_g"] == 1).all())
    assert not bool((leaf[0] == draft_leaf[0]).any())
    assert draft_params["encoder"] is teacher.params["encoder"]
    with pytest.raises(ValueError):
        make_draft_dims(DIMS, 0)
    with pytest.raises(ValueError):
        make_draft_dims(DIMS, DIMS.n_text_layer + 1)
    # the same leaves as whisper_tpu's
    for n in (1, 2, 3):
        jp, _ = jdistill.init_draft_from_teacher(jteacher.params, JD, n_text_layer=n)
        tp, _ = init_draft_from_teacher(teacher.params, DIMS, n_text_layer=n)
        ref = params_from_numpy(_np({"encoder": jteacher.params["encoder"], "decoder": jp["decoder"]}),
                                DIMS)["decoder"]
        for k, v in ref["blocks"].items():
            torch.testing.assert_close(tp["decoder"]["blocks"][k], v, rtol=0, atol=0)


def test_self_distillation_loss_is_zero(teacher, pseudo_batch):
    """KL(teacher ‖ teacher) == 0: the loss is a true divergence."""
    loss = distill_loss(teacher.params["decoder"], teacher.params, DIMS, DIMS, pseudo_batch)
    assert abs(float(loss)) < 1e-3


def _state(decoder, optimizer):
    return DistillState(decoder, optimizer.init(decoder), 0)


def test_distill_loss_descends_and_acceptance_improves(teacher, pseudo_batch):
    draft_params, draft_dims = init_draft_from_teacher(teacher.params, DIMS, n_text_layer=1)
    optimizer = make_optimizer(learning_rate=1e-3)
    state = _state(draft_params["decoder"], optimizer)
    init_draft = Whisper(draft_dims, {"encoder": teacher.params["encoder"],
                                      "decoder": {k: v for k, v in state.decoder.items()}})
    acc_init = offline_acceptance(init_draft, pseudo_batch["tokens"], pseudo_batch["features"],
                                  pseudo_batch["loss_mask"])

    losses = []
    for _ in range(120):
        state, metrics = distill_step(state, teacher.params, draft_dims, DIMS, optimizer, pseudo_batch)
        losses.append(float(metrics["loss"]))
    assert int(state.step) == 120
    assert min(losses[-10:]) < 0.5 * losses[0], (losses[0], losses[-1])

    trained = Whisper(draft_dims, {"encoder": teacher.params["encoder"], "decoder": state.decoder})
    acc_trained = offline_acceptance(trained, pseudo_batch["tokens"], pseudo_batch["features"],
                                     pseudo_batch["loss_mask"])
    # the only thing a draft buys is acceptance: it must move
    assert acc_trained > acc_init, (acc_init, acc_trained)
    assert acc_trained > 0.5, acc_trained


def test_distill_end_to_end_decode_exact(teacher, mels, pseudo_batch):
    """distill() returns a Whisper that plugs into decode(draft_model=...)
    with token-exact output (shared-encoder speculative path)."""
    draft = distill(teacher, (pseudo_batch for _ in range(60)), n_text_layer=1, learning_rate=1e-3)
    assert draft.dims.n_text_layer == 1
    assert draft.dtype == teacher.dtype and draft.params["encoder"] is teacher.params["encoder"]
    assert not any(v.requires_grad for v in draft.params["decoder"]["blocks"].values())
    assert not draft.params["decoder"]["tok_emb"].requires_grad

    opts = DecodingOptions(language="en", temperature=0.0, sample_len=16, without_timestamps=True)
    plain = whisper_tpu_torch.decode(teacher, mels, opts)
    spec = whisper_tpu_torch.decode(teacher, mels, opts, draft_model=draft)
    for p, s in zip(plain, spec):
        assert p.tokens == s.tokens
        assert abs(p.avg_logprob - s.avg_logprob) < 1e-4


def test_distill_accepts_mel_batches(teacher, mels, pseudo_batch):
    """Batches may carry raw mel; the shared frozen encoder runs inside."""
    batch = {"mel": mels, "tokens": pseudo_batch["tokens"], "loss_mask": pseudo_batch["loss_mask"]}
    draft = distill(teacher, [batch], n_text_layer=2)
    assert draft.dims.n_text_layer == 2
    # the same first step as from the features
    ref = distill(teacher, [pseudo_batch], n_text_layer=2)
    for k, v in ref.params["decoder"]["blocks"].items():
        torch.testing.assert_close(draft.params["decoder"]["blocks"][k], v, rtol=0, atol=1e-7)


@pytest.mark.parametrize("ce_weight", [0.0, 0.5])
def test_distill_loss_and_step_match_whisper_tpu(teacher, jteacher, pseudo_batch, ce_weight):
    jbatch = _jbatch(pseudo_batch)
    jdraft, jdims = jdistill.init_draft_from_teacher(jteacher.params, JD, n_text_layer=1)
    draft, ddims = init_draft_from_teacher(teacher.params, DIMS, n_text_layer=1)
    ref = float(jdistill.distill_loss(jdraft["decoder"], jteacher.params, jdims, JD, jbatch,
                                      ce_weight))
    got = float(distill_loss(draft["decoder"], teacher.params, ddims, DIMS, pseudo_batch, ce_weight))
    assert ref > 0 and abs(got - ref) <= 1e-5 * ref + 1e-6, (got, ref)

    jopt = jt.make_optimizer(learning_rate=1e-3)
    jstate = jdistill.DistillState(jdraft["decoder"], jopt.init(jdraft["decoder"]), jnp.int32(0))
    jstate, jm = jdistill.distill_step(jstate, jteacher.params, jdims, JD, jopt, jbatch,
                                       ce_weight=ce_weight)
    opt = make_optimizer(learning_rate=1e-3)
    state, m = distill_step(_state(draft["decoder"], opt), teacher.params, ddims, DIMS, opt,
                            pseudo_batch, ce_weight=ce_weight)
    assert state.step == int(jstate.step) == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"]) + 1e-6
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])


def test_offline_acceptance_matches_whisper_tpu(teacher, jteacher, pseudo_batch):
    jbatch = _jbatch(pseudo_batch)
    for n in (1, 3):
        jdraft, jdims = jdistill.init_draft_from_teacher(jteacher.params, JD, n_text_layer=n)
        draft, ddims = init_draft_from_teacher(teacher.params, DIMS, n_text_layer=n)
        for mask in (True, False):
            ref = jdistill.offline_acceptance(
                JWhisper(jdims, jdraft), jbatch["tokens"], jbatch["features"],
                jbatch["loss_mask"] if mask else None)
            got = offline_acceptance(
                Whisper(ddims, draft), pseudo_batch["tokens"], pseudo_batch["features"],
                pseudo_batch["loss_mask"] if mask else None)
            assert got == ref, (n, mask, got, ref)


def test_distill_step_decreases_loss(teacher):
    """tests/test_parallel.py's distill-step case on one device."""
    dims = ModelDimensions(**dict(KW, n_text_layer=2))
    params = params_from_numpy(_np(j_init_params(JDims(**dict(KW, n_text_layer=2)),
                                                 jax.random.PRNGKey(3))), dims)
    draft_params, draft_dims = init_draft_from_teacher(params, dims, 1)
    optimizer = make_optimizer(learning_rate=1e-3)
    state = _state(draft_params["decoder"], optimizer)
    rng = np.random.RandomState(0)
    mel = torch.from_numpy(rng.randn(4, 80, 3000).astype(np.float32))
    with torch.no_grad():
        features = encoder_apply(params, dims, mel)
    batch = {
        "features": features,
        "tokens": torch.tensor([[50258, 50259, 50359, 50363, 440, 7177, 300, 50257]] * 4),
        "loss_mask": torch.ones((4, 8)),
    }
    with torch.no_grad():
        loss0 = float(distill_loss(state.decoder, params, draft_dims, dims, batch))
    for _ in range(3):
        state, metrics = distill_step(state, params, draft_dims, dims, optimizer, batch)
    loss1 = float(metrics["loss"])
    assert np.isfinite(loss0) and np.isfinite(loss1)
    assert loss1 < loss0


def test_all_names_match_whisper_tpu():
    assert td.__all__ == jdistill.__all__
    for name in td.__all__:
        assert callable(getattr(td, name))
