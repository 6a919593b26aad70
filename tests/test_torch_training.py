"""whisper_tpu_torch.training against whisper_tpu.training on the CPU.

The same weights in both packages (whisper_tpu's init_params through
params_from_numpy) at tests/test_parallel.py's dims, the same mels, tokens
and masks from numpy seeds.  On the CPU whisper_tpu's encoder attention is
XLA's (``qkv_attention``), as the port's training pass uses.  Tolerances:

- ``loss_fn``: within 1e-5 relative;
- every gradient leaf against ``jax.grad``'s: max-abs difference within
  1e-4 x that leaf's max-abs plus 1e-7;
- one ``train_step``: loss within 1e-5 relative, grad_norm within 1e-4
  relative, step equal; every parameter within 1e-3 x lr of JAX's, except
  where the gradient is near zero, where within 2 x lr.  Adam's first step
  moves each weight by lr x g / (|g| + eps) (the bias corrections cancel),
  g the clipped gradient, so a difference d between the two packages'
  gradients moves a weight by up to lr x d x eps / (|g| + eps)^2, and by
  at most 2 lr.  Near zero is therefore either of: |g| < 1e-6 x its leaf's
  max-abs (g at the level of the rounding noise of a sum over the leaf,
  its sign noise), or |g| < 100 x eps = 1e-6 (where that factor reaches
  1e6 / |g| and a difference of 1e-10, a few f32 roundings of a clipped
  gradient, moves the step by more than 1e-3 x lr: the default max norm
  scales these gradients by 1/14 into that range).  Elsewhere the step is
  lr x sign(g) to within 1e-3 x lr;
- clipping: the clipped gradients against optax's ``clip_by_global_norm``
  within the gradient rule (which ``torch.nn.utils.clip_grad_norm_``'s
  extra 1e-6 in the divisor would break at a small max norm);
- three steps: each loss within 1e-4 relative;
- ``decoder_apply_train``: logits within 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import whisper_tpu.training as jt
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.whisper import encoder_apply as j_encoder_apply
from whisper_tpu.models.whisper import init_params as j_init_params

import whisper_tpu_torch.ops.attention as tattn
import whisper_tpu_torch.training as tt
from whisper_tpu_torch import quantize as tq
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.load import params_from_numpy
from whisper_tpu_torch.models.whisper import Whisper, encoder_apply, init_params
from whisper_tpu_torch.ops.kernels import _lib

torch.set_num_threads(2)

KW = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
          n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
JD, TD = JDims(**KW), ModelDimensions(**KW)
TOKENS = [50258, 50259, 50359, 50363, 440, 7177, 300, 50257]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    """A whisper_tpu tree (params or gradients) in the port's layout."""
    return params_from_numpy(_np(tree), TD)


def _batch(B: int = 2, seed: int = 0):
    """numpy mel, tokens and a padding mask: row 0 scores the text and EOT,
    later rows also have a padded tail."""
    rng = np.random.RandomState(seed)
    mel = (rng.randn(B, 80, 3000) * 0.5).astype(np.float32)
    tokens = np.tile(np.asarray(TOKENS, np.int32), (B, 1))
    mask = np.zeros((B, len(TOKENS)), np.float32)
    mask[:, 4:] = 1.0
    mask[1:, -2:] = 0.0
    return dict(mel=mel, tokens=tokens, loss_mask=mask)


def _jcopy(tree):
    """A copy of a whisper_tpu tree: its train_step donates its state."""
    return jax.tree.map(jnp.array, tree)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(JD, jax.random.PRNGKey(0))


def _pairs(port_tree, ref_tree, path=""):
    """(path, port leaf, reference leaf) over two port-layout trees."""
    if isinstance(port_tree, dict):
        for k in sorted(port_tree):
            yield from _pairs(port_tree[k], ref_tree[k], f"{path}/{k}")
    else:
        yield path, port_tree, ref_tree


def _close_leaves(port_tree, ref_tree, rel: float = 1e-4, atol: float = 1e-7):
    bad = []
    for path, got, want in _pairs(port_tree, ref_tree):
        got = got.detach() if isinstance(got, torch.Tensor) else got
        err = (got - want).abs().max().item()
        if not err <= rel * want.abs().max().item() + atol:
            bad.append((path, err, want.abs().max().item()))
    assert bad == []


def test_loss_matches_whisper_tpu(jparams):
    b = _batch()
    ref = float(jt.loss_fn(jparams, JD, _jbatch(b)))
    got = tt.loss_fn(_port(jparams), TD, _tbatch(b)).item()
    assert np.isfinite(ref) and abs(got - ref) <= 1e-5 * abs(ref), (got, ref)


def test_gradients_match_jax_grad(jparams):
    b = _batch()
    jgrads = _port(jax.grad(jt.loss_fn)(jparams, JD, _jbatch(b)))
    params = _port(jparams)
    leaves = tt.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    grads = torch.autograd.grad(tt.loss_fn(params, TD, _tbatch(b)), leaves)
    grad_tree = _rebuild(params, iter(grads))
    # the encoder's attention is differentiated: its projections take gradients
    for name in ("q_w", "k_w", "v_w", "v_b", "q_b"):
        assert grad_tree["encoder"]["blocks"][name].abs().max() > 0, name
    _close_leaves(grad_tree, jgrads)


def _rebuild(tree, leaves):
    """A tree of tree's shape from leaves in param_leaves order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


ADAM_EPS = 1e-8


def _params_close(port_tree, ref_tree, jgrads, lr: float):
    """The parameter rule of the module docstring; jgrads: the gradients
    Adam saw (clipped)."""
    bad = []
    for (path, got, want), (_, _, g) in zip(_pairs(port_tree, ref_tree), _pairs(port_tree, jgrads)):
        err = (got.detach() - want).abs()
        near_zero = (g.abs() < 1e-6 * g.abs().max()) | (g.abs() < 100 * ADAM_EPS)
        tol = torch.where(near_zero, 2 * lr, 1e-3 * lr)
        if not bool((err <= tol).all()):
            bad.append((path, err.max().item()))
    assert bad == []


@pytest.mark.parametrize("max_grad_norm", [1.0, 1e-3, 1e6])
def test_one_train_step_matches_optax(jparams, max_grad_norm):
    """One step at lr 1e-3: a max norm the gradients exceed (1.0, the
    default, and 1e-3) or do not (1e6).  The clipped gradients left on the
    leaves equal optax's clip_by_global_norm of JAX's."""
    lr, b = 1e-3, _batch()
    jgrads = jax.grad(jt.loss_fn)(jparams, JD, _jbatch(b))
    jnorm = float(optax.global_norm(jgrads))
    jclipped, _ = optax.clip_by_global_norm(max_grad_norm).update(jgrads, optax.EmptyState())
    jopt = jt.make_optimizer(learning_rate=lr, max_grad_norm=max_grad_norm)
    jstate, jmetrics = jt.train_step(jt.init_train_state(_jcopy(jparams), jopt), JD, jopt,
                                      _jbatch(b))

    opt = tt.make_optimizer(learning_rate=lr, max_grad_norm=max_grad_norm)
    state = tt.init_train_state(_port(jparams), opt)
    state, metrics = tt.train_step(state, TD, opt, _tbatch(b))

    assert state.step == metrics["step"] == int(jmetrics["step"]) == 1
    assert abs(metrics["loss"].item() - float(jmetrics["loss"])) <= 1e-5 * abs(float(jmetrics["loss"]))
    assert abs(metrics["grad_norm"].item() - jnorm) <= 1e-4 * jnorm
    assert (jnorm >= max_grad_norm) == (max_grad_norm < 1e6)
    _close_leaves(_rebuild(state.params, (p.grad for p in tt.param_leaves(state.params))),
                  _port(jclipped))
    _params_close(state.params, _port(jstate.params), _port(jclipped), lr)


def test_three_train_steps_match(jparams):
    lr, b = 1e-3, _batch()
    jopt = jt.make_optimizer(learning_rate=lr)
    jstate = jt.init_train_state(_jcopy(jparams), jopt)
    opt = tt.make_optimizer(learning_rate=lr)
    state = tt.init_train_state(_port(jparams), opt)
    for _ in range(3):
        jstate, jm = jt.train_step(jstate, JD, jopt, _jbatch(b))
        state, m = tt.train_step(state, TD, opt, _tbatch(b))
        assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
    assert state.step == 3


def test_decoder_apply_train_matches(jparams):
    b = _batch()
    jfeats = j_encoder_apply(jparams, JD, jnp.asarray(b["mel"]))
    ref = np.asarray(jt.decoder_apply_train(jparams, JD, jnp.asarray(b["tokens"]), jfeats))
    with torch.no_grad():
        got = tt.decoder_apply_train(_port(jparams), TD, torch.from_numpy(b["tokens"]),
                                     torch.from_numpy(np.array(jfeats)))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4)


def test_train_step_decreases_loss():
    """tests/test_parallel.py's train-step case on one device."""
    params = _port(j_init_params(JD, jax.random.PRNGKey(0)))
    opt = tt.make_optimizer(learning_rate=1e-3)
    state = tt.init_train_state(params, opt)
    rng = np.random.RandomState(0)
    batch = {
        "mel": torch.from_numpy(rng.randn(4, 80, 3000).astype(np.float32)),
        "tokens": torch.tensor([TOKENS] * 4, dtype=torch.int32),
        "loss_mask": torch.ones((4, 8)),
    }
    with torch.no_grad():
        loss0 = tt.loss_fn(state.params, TD, batch).item()
    for _ in range(3):
        state, metrics = tt.train_step(state, TD, opt, batch)
    loss1 = metrics["loss"].item()
    assert np.isfinite(loss0) and np.isfinite(loss1)
    assert loss1 < loss0


def test_inference_tensors_are_accepted(jparams):
    """A batch made under inference_mode trains as the same batch made
    outside it."""
    b = _batch()
    with torch.inference_mode():
        frozen = {k: v.clone() for k, v in _tbatch(b).items()}
    assert all(v.is_inference() for v in frozen.values())
    losses = []
    for batch in (_tbatch(b), frozen):
        opt = tt.make_optimizer(learning_rate=1e-3)
        state = tt.init_train_state(_port(jparams), opt)
        state, m = tt.train_step(state, TD, opt, batch)
        losses.append((m["loss"].item(), m["grad_norm"].item()))
    assert losses[0] == losses[1]


def test_loss_fn_never_calls_k1(monkeypatch):
    """The training pass runs the encoder's attention on stock torch ops,
    never K1's wrapper (whose kernel has no backward), on any device: at
    head dim 64, which inference sends to K1."""
    def refuse(*args):
        raise AssertionError("K1's wrapper called by a training pass")

    monkeypatch.setattr(tattn, "_attention_kernel", refuse)
    b = _batch()
    dims = ModelDimensions(**dict(KW, n_audio_head=1))
    params = init_params(dims, torch.Generator().manual_seed(0))
    for p in tt.param_leaves(params):
        p.requires_grad_(True)
    tt.loss_fn(params, dims, _tbatch(b)).backward()
    assert params["encoder"]["blocks"]["q_w"].grad.abs().max() > 0
    with pytest.raises(AssertionError, match="K1's wrapper"):
        encoder_apply(params, dims, torch.from_numpy(b["mel"]))  # inference's dispatch still reaches it


def test_int8_parameters_are_refused(jparams):
    params = tq.quantize_params(_port(jparams))
    with pytest.raises(ValueError, match="int8"):
        tt.init_train_state(params, tt.make_optimizer())


def test_optimizer_carries_its_hyperparameters():
    opt = tt.make_optimizer(2e-4, weight_decay=0.1, max_grad_norm=0.5)
    assert (opt.learning_rate, opt.weight_decay, opt.max_grad_norm) == (2e-4, 0.1, 0.5)
    w = torch.zeros(3)
    adamw = opt.init({"w": w})
    assert isinstance(adamw, torch.optim.AdamW) and w.requires_grad
    group = adamw.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        2e-4, (0.9, 0.999), 1e-8, 0.1)


@pytest.mark.parametrize("form", ["tensor", "int8", "dict"])
def test_refuse_grad_names_the_kernel(form):
    """The check every CUDA wrapper makes before it launches: an input that
    requires grad under grad mode raises, naming the kernel; under no_grad
    and inference_mode, or with no such input, it passes."""
    w = torch.ones(4, 4, requires_grad=True)
    arg = {"tensor": w, "int8": tq.Int8Weight(torch.ones(4, dtype=torch.int8), w),
           "dict": {"blocks": {"q_w": w}}}[form]
    with pytest.raises(RuntimeError, match="K1.*no backward"):
        _lib.refuse_grad("encoder_attention (K1)", torch.ones(2), arg, None)
    with torch.no_grad():
        _lib.refuse_grad("encoder_attention (K1)", arg)
    with torch.inference_mode():
        _lib.refuse_grad("encoder_attention (K1)", arg)
    _lib.refuse_grad("encoder_attention (K1)", torch.ones(2), None, {"a": [torch.ones(1)]})


def test_trained_model_still_decodes(jparams):
    """After a step the leaves require grad; the decode paths run under
    inference_mode, so a trained model transcribes as any other."""
    opt = tt.make_optimizer(learning_rate=1e-3)
    state = tt.init_train_state(_port(jparams), opt)
    state, _ = tt.train_step(state, TD, opt, _tbatch(_batch()))
    model = Whisper(TD, state.params)
    result = model.decode(torch.from_numpy(_batch(1)["mel"][0]), language="en", sample_len=4)
    assert len(result.tokens) <= 4 and np.isfinite(result.avg_logprob)
