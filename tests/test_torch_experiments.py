"""The plain versions of E1-E3, the ports of the Pallas kernels under
``scripts/``, against the scripts' own computations on the CPU.

E1: ``matmul_residual_plain`` against ``matmul_residual_pallas`` (imported
from ``scripts/`` as ``bench_encoder_ops.py`` imports it) run as the real
kernel body under ``force_tpu_interpret_mode``, and against ``res +
whisper_tpu.models.whisper._linear(x, w, b)``, the formulation it was
built to match.  E2 and E3 are closures inside their scripts' ``main``, so
the oracles restate their bodies in ``jnp``: E2 the ``dot_general`` of
variants D and E (the einsums of variants A and B), E3 ``kernel_unpacked``
and ``kernel_packed``.  Inputs are made with numpy from a seed and given to
both.  On a CPU tensor each wrapper takes its plain version and counts no
launch; the kernels are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import whisper_tpu.models.whisper as jw

from whisper_tpu_torch.experiments import attn_packed as attn_packed_experiment
from whisper_tpu_torch.experiments import encoder_ops, logits as logits_experiment
from whisper_tpu_torch.ops.kernels import attn_packed, logits, matmul_residual

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
from _matmul_pallas_experiment import matmul_residual_pallas  # noqa: E402

torch.set_num_threads(2)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# -- E1 ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def e1_inputs():
    """M = 300 (no multiple of the 128-row block), K = 1024, N = 256."""
    rng = np.random.RandomState(0)
    M, K, N = 300, 1024, 256
    return (rng.randn(M, K) * 0.3, rng.randn(K, N) * 0.02, rng.randn(N) * 0.1, rng.randn(M, N) * 0.3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_e1_plain_matches_the_pallas_body(e1_inputs, dtype):
    """f32: atol 1e-5 (the same function summed in another order).  bf16:
    within one bf16 ulp of the output (the f32 sums may round to
    neighbouring bf16 values; bias and residual then add alike)."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = matmul_residual_pallas(*(jnp.asarray(a, jd) for a in e1_inputs), bm=128, bk=512)
    ref = np.asarray(ref.astype(jnp.float32))
    args = [torch.from_numpy(a.astype(np.float32)).to(td) for a in e1_inputs]
    launches = matmul_residual.matmul_residual.launches
    got = matmul_residual.matmul_residual(*args)
    assert matmul_residual.matmul_residual.launches == launches  # a CPU tensor launches nothing
    assert got.dtype == td and got.shape == ref.shape
    diff = np.abs(got.float().numpy() - ref)
    if dtype == "float32":
        assert diff.max() <= 1e-5
    else:
        assert (diff <= _bf16_ulp(ref)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_e1_plain_matches_linear_plus_residual(e1_inputs, dtype):
    """The formulation E1 was built to match: res + _linear(x, w, b), the
    JAX encoder's fc2 and its residual.  Tolerances as above."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x, w, b, res = (jnp.asarray(a, jd) for a in e1_inputs)
    ref = np.asarray((res + jw._linear(x, w, b)).astype(jnp.float32))
    got = matmul_residual.matmul_residual_plain(
        *(torch.from_numpy(a.astype(np.float32)).to(td) for a in e1_inputs)).float().numpy()
    diff = np.abs(got - ref)
    assert diff.max() <= 1e-5 if dtype == "float32" else (diff <= _bf16_ulp(ref)).all()


def test_e1_shape_predicate():
    assert matmul_residual.fits(5120, 1280) and matmul_residual.fits(32, 8)
    assert not matmul_residual.fits(5120 + 16, 1280) and not matmul_residual.fits(5120, 1284)


# -- E2 ---------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["vc", "cv"])
@pytest.mark.parametrize("B", [1, 5, 16])
def test_e2_plain_matches_the_scripts_contraction(layout, B):
    """C = 128, V = 1000 (no multiple of 128), bf16 inputs: every product
    is exact in f32, so only the order of the f32 sums differs; max error
    1e-5 of max |logit|."""
    rng = np.random.RandomState(B)
    x = (rng.randn(B, 128) * 0.5).astype(np.float32)
    emb = (rng.randn(1000, 128) * 0.02).astype(np.float32)
    w = emb if layout == "vc" else np.ascontiguousarray(emb.T)
    spec = "bc,vc->bv" if layout == "vc" else "bc,cv->bv"
    ref = np.asarray(jnp.einsum(spec, jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                preferred_element_type=jnp.float32))
    launches = logits.logits_streamed.launches
    got = logits.logits_streamed(torch.from_numpy(x).to(torch.bfloat16),
                                 torch.from_numpy(w).to(torch.bfloat16), layout)
    assert logits.logits_streamed.launches == launches
    assert got.dtype == torch.float32 and got.shape == (B, 1000)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_e2_refuses_an_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        logits.logits_streamed(torch.zeros(1, 32), torch.zeros(8, 32), "vv")


# -- E3 ---------------------------------------------------------------------

G, Q, T, D, REPS = 2, 32, 96, 64, 3


def _jnp_unpacked(q, k1, v1, k2, v2, reps):
    """kernel_unpacked's body over the g programs at once."""
    q1, q2 = q[..., :D], q[..., D:]

    def body(_, acc):
        qq1 = q1 + acc[..., :D].astype(q.dtype) * 1e-9
        qq2 = q2 + acc[..., D:].astype(q.dtype) * 1e-9
        s1 = jnp.einsum("gqd,gtd->gqt", qq1, k1, preferred_element_type=jnp.float32)
        o1 = jnp.einsum("gqt,gtd->gqd", s1.astype(q.dtype), v1, preferred_element_type=jnp.float32)
        s2 = jnp.einsum("gqd,gtd->gqt", qq2, k2, preferred_element_type=jnp.float32)
        o2 = jnp.einsum("gqt,gtd->gqd", s2.astype(q.dtype), v2, preferred_element_type=jnp.float32)
        return acc + jnp.concatenate([o1, o2], axis=-1) * 1e-9

    acc = jax.lax.fori_loop(0, reps, body, jnp.zeros(q.shape, jnp.float32))
    return acc.astype(q.dtype)


def _jnp_packed(q, k, v, reps):
    """kernel_packed's body over the g programs at once."""

    def body(_, acc):
        qq = q + acc.astype(q.dtype) * 1e-9
        s = jnp.einsum("gqd,gtd->gqt", qq, k, preferred_element_type=jnp.float32)
        o = jnp.einsum("gqt,gtd->gqd", s.astype(q.dtype), v, preferred_element_type=jnp.float32)
        return acc + o * 1e-9

    acc = jax.lax.fori_loop(0, reps, body, jnp.zeros(q.shape, jnp.float32))
    return acc.astype(q.dtype)


@pytest.fixture(scope="module")
def e3_inputs():
    rng = np.random.RandomState(0)
    q2 = (rng.randn(G, Q, 2 * D) * 0.1).astype(np.float32)
    return [q2] + [(rng.randn(G, T, D) * 0.1).astype(np.float32) for _ in range(4)]


def _bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _close(got: torch.Tensor, ref) -> float:
    """max error over max |ref|, held to 8e-3: one bf16 ulp of the largest
    output (an ulp is at most 2^-7 of a bf16 value).  The scores round to
    bf16 after f32 sums in another order, so a score may land one ulp away
    and move an output across a rounding boundary."""
    ref = np.asarray(ref.astype(jnp.float32))
    return np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()


def test_e3_unpacked_plain_matches_the_scripts_body(e3_inputs):
    q2, k1, v1, k2, v2 = e3_inputs
    ref = _jnp_unpacked(*(jnp.asarray(a, jnp.bfloat16) for a in e3_inputs), REPS)
    launches = attn_packed.attn_pairs_unpacked.launches
    got = attn_packed.attn_pairs_unpacked(*_bf16(q2, k1, v1, k2, v2), REPS)
    assert attn_packed.attn_pairs_unpacked.launches == launches
    assert got.dtype == torch.bfloat16 and got.shape == (G, Q, 2 * D)
    assert _close(got, ref) <= 8e-3


def test_e3_packed_plain_matches_the_scripts_body_and_unpacked(e3_inputs):
    """On block-diagonal operands the packed product adds exact zeros to the
    unpacked one's sums: the two agree as closely as each does its oracle."""
    q2, k1, v1, k2, v2 = e3_inputs
    tq, tk1, tv1, tk2, tv2 = _bf16(q2, k1, v1, k2, v2)
    kp = attn_packed_experiment.block_diagonal(tk1, tk2)
    vp = attn_packed_experiment.block_diagonal(tv1, tv2)
    assert kp.shape == vp.shape == (G, 2 * T, 2 * D)
    ref = _jnp_packed(jnp.asarray(q2, jnp.bfloat16), jnp.asarray(kp.float().numpy(), jnp.bfloat16),
                      jnp.asarray(vp.float().numpy(), jnp.bfloat16), REPS)
    launches = attn_packed.attn_pairs_packed.launches
    got = attn_packed.attn_pairs_packed(tq, kp, vp, REPS)
    assert attn_packed.attn_pairs_packed.launches == launches
    assert _close(got, ref) <= 8e-3
    unpacked = attn_packed.attn_pairs_unpacked(tq, tk1, tv1, tk2, tv2, REPS)
    assert _close(got, np.asarray(unpacked.float().numpy())) <= 8e-3


# -- the entry points -------------------------------------------------------


@pytest.mark.parametrize("module,argv,n_rows", [
    (encoder_ops, ["--batch", "1", "--heads", "2", "--t", "64", "--d", "128", "--c", "64"], 6),
    (logits_experiment, ["--batch", "5", "--vocab", "200", "--width", "64", "--inner", "1", "--outer", "1"], 6),
    (attn_packed_experiment, ["--grid", "1", "--q", "16", "--t", "32", "--reps", "2", "--repeats", "1"], 2),
])
def test_experiment_entry_points_run_on_the_cpu(module, argv, n_rows, capsys):
    """Each entry point runs the kernels' plain versions when asked for the
    CPU, prints a line per variant with its bound, and says so."""
    rows = module.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(rows) == n_rows and all(r["ms"] > 0 and r["bound_ms"] > 0 for r in rows)
    assert "host times, not a card's" in out and out.count(" bound ") >= n_rows


def test_experiment_entry_points_default_to_the_card():
    """Without --device an entry point asks for CUDA, and raises where there
    is none: it never moves to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        logits_experiment.main(["--vocab", "16", "--width", "32"])
