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
(tests/test_torch_cuda.py, chip_smoke.py).  Beside them: E1's bf16 check
(``bf16_rounding_bound``) against a product summed in float64 and against
planted faults, and E3 in the card kernel's order of sums (partial o over
key slices, added in rank order), also on inputs where every rep's
feedback moves the queries.
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


def _e1_reordered(x, w, bias, res, fault=None):
    """E1 as a correct kernel may compute it: the product summed in another
    order (float64 here) and rounded once to bf16, then the bias and the
    residual added in bf16.  fault "bias" drops the bias from the epilogue;
    "last_k_tile" skips the last 64 of K (the bf16 kernel's K step)."""
    x64, w64 = x.double(), w.double()
    if fault == "last_k_tile":
        x64, w64 = x64[:, :-64], w64[:-64]
    y = (x64 @ w64).to(torch.bfloat16)
    return (y if fault == "bias" else y + bias) + res


@pytest.mark.parametrize("fault", [None, "bias", "last_k_tile"])
def test_e1_bf16_bound_holds_for_another_order_and_catches_faults(e1_inputs, fault):
    """bf16_rounding_bound, the card's bf16 check of E1: a product summed in
    float64 and rounded lies within it of matmul_residual_plain at every
    element (and differs from it somewhere: the three roundings are
    crossed); the planted faults break it at most elements."""
    x, w, bias, res = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in e1_inputs)
    ref = matmul_residual.matmul_residual_plain(x, w, bias, res).float()
    bound = matmul_residual.bf16_rounding_bound(x, w, bias, res)
    assert bound.shape == ref.shape and bound.dtype == torch.float32
    diff = (_e1_reordered(x, w, bias, res, fault).float() - ref).abs()
    if fault is None:
        assert (diff <= bound).all() and (diff > 0).any()
    else:
        assert (diff > bound).float().mean().item() > 0.5


def test_e1_bf16_bound_is_three_ulps_at_the_plain_binades():
    """The bound's ulps: 2^(e - 8) in [2^(e - 1), 2^e), doubled at the
    binade's largest value (one ulp below the next power of two)."""
    v = torch.tensor([1.0, 1.0 - 2**-8, 2.0 - 2**-7, 2.0, 0.1, -3.0]).to(torch.bfloat16)
    assert matmul_residual._ulp_bound(v).tolist() == [2**-7, 2**-7, 2**-6, 2**-6, 2**-11, 2**-6]
    one = torch.ones(1, 1, dtype=torch.bfloat16)
    # y = 1, t = 1 + 1 = 2, out = 2 + 1 = 3: ulps 2^-7, 2^-6, 2^-6
    bound = matmul_residual.bf16_rounding_bound(one, one, one.reshape(1), one)
    assert bound.item() == 2**-7 + 2**-6 + 2**-6


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


def _e3_sliced(q, pairs, reps, split):
    """E3 in the card's order of sums: for each pair, `split` ranks of a
    cluster take `keys` keys each (ceil(T / split) rounded up to the 64-key
    chunk; the last ranks may hold none), a rank's partial o adds its
    chunks' bf16(s) v in f32, and the partials meet in rank order.  pairs:
    [(q's columns, k, v)]."""
    eps = torch.tensor(1e-9, dtype=torch.bfloat16)
    acc = torch.zeros(q.shape, dtype=torch.float32)
    for _ in range(reps):
        outs = []
        for cols, k, v in pairs:
            qq = (q[..., cols] + acc[..., cols].to(q.dtype) * eps).float()
            T = k.shape[1]
            keys = -(-(-(-T // split)) // 64) * 64
            o = None
            for rank in range(split):
                part = torch.zeros(qq.shape[:-1] + (v.shape[-1],))
                for c0 in range(rank * keys, min(T, (rank + 1) * keys), 64):
                    s = torch.matmul(qq, k[:, c0:c0 + 64].float().transpose(-1, -2))
                    part = part + torch.matmul(s.to(q.dtype).float(), v[:, c0:c0 + 64].float())
                o = part if o is None else o + part
            outs.append(o)
        acc = acc + torch.cat(outs, dim=-1) * 1e-9
    return acc.to(q.dtype)


def _e3_hoisted(q, k1, v1, k2, v2, reps):
    """E3 unpacked as a kernel that hoisted its rep loop would compute it:
    rep 0's o, times 1e-9, added reps times."""
    pairs = [(slice(0, D), k1, v1), (slice(D, 2 * D), k2, v2)]
    o = attn_packed._rep(q, torch.zeros(q.shape), pairs)
    acc = torch.zeros(q.shape)
    for _ in range(reps):
        acc = acc + o
    return acc.to(q.dtype)


E3_SLICED_T = 320  # slices of 320, 192 + 128, 128 x 2 + 64 + 0, 64 x 5 + 0 x 3 keys


@pytest.fixture(scope="module")
def e3_sliced_refs():
    """The scripts' bodies (jnp) on numpy-seeded inputs at T = 320 (packed
    640), at the experiment's scale and at chain_scale: computed once for
    the splits."""
    refs = {}
    for scale in ("0.1", "chain"):
        rng = np.random.RandomState(5)
        sk = 0.1 if scale == "0.1" else attn_packed_experiment.chain_scale(E3_SLICED_T)
        q2 = (rng.randn(G, Q, 2 * D) * 0.1).astype(np.float32)
        kv = [(rng.randn(G, E3_SLICED_T, D) * sk).astype(np.float32) for _ in range(4)]
        t = _bf16(q2, *kv)
        kp, vp = attn_packed_experiment.block_diagonal(t[1], t[3]), attn_packed_experiment.block_diagonal(t[2], t[4])
        jb = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (*t, kp, vp)]
        refs[scale] = dict(
            t=t, kp=kp, vp=vp,
            unpacked=np.asarray(_jnp_unpacked(*jb[:5], REPS).astype(jnp.float32)),
            packed=np.asarray(_jnp_packed(jb[0], jb[5], jb[6], REPS).astype(jnp.float32)))
    return refs


@pytest.mark.parametrize("scale", ["0.1", "chain"])
@pytest.mark.parametrize("variant", ["unpacked", "packed"])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_e3_slicing_keeps_the_scripts_numerics(e3_sliced_refs, scale, variant, split):
    """The card's E3 order of sums (partial o over `split` key slices of
    64-key chunks, added in rank order) against the scripts' bodies, within
    8e-3 of the largest output, at the experiment's scale and where every
    rep's feedback moves qq (chain_scale)."""
    r = e3_sliced_refs[scale]
    q2, k1, v1, k2, v2 = r["t"]
    if variant == "unpacked":
        got = _e3_sliced(q2, [(slice(0, D), k1, v1), (slice(D, 2 * D), k2, v2)], REPS, split)
    else:
        got = _e3_sliced(q2, [(slice(None), r["kp"], r["vp"])], REPS, split)
    assert _close(got, jnp.asarray(r[variant])) <= 8e-3


def test_e3_chain_visible_inputs_make_every_rep_count(e3_sliced_refs):
    """At the experiment's scale the feedback is far under half an ulp of q:
    every rep's o is the same, and the hoisted loop gives the plain output
    bit for bit.  At chain_scale the plain outputs at reps and reps + 1,
    and the hoisted loop's, lie beyond the tolerance, and the plain
    versions still agree with the scripts' bodies within it."""
    q2, k1, v1, k2, v2 = e3_sliced_refs["0.1"]["t"]
    assert torch.equal(attn_packed.attn_pairs_unpacked_plain(q2, k1, v1, k2, v2, REPS),
                       _e3_hoisted(q2, k1, v1, k2, v2, REPS))
    r = e3_sliced_refs["chain"]
    q2, k1, v1, k2, v2 = r["t"]
    got = attn_packed.attn_pairs_unpacked_plain(q2, k1, v1, k2, v2, REPS)
    ref = np.asarray(got.float().numpy())
    for other in (attn_packed.attn_pairs_unpacked_plain(q2, k1, v1, k2, v2, REPS + 1),
                  _e3_hoisted(q2, k1, v1, k2, v2, REPS)):
        assert _close(other, jnp.asarray(ref)) > 8e-3
    assert _close(got, jnp.asarray(r["unpacked"])) <= 8e-3
    assert _close(attn_packed.attn_pairs_packed_plain(q2, r["kp"], r["vp"], REPS), jnp.asarray(r["packed"])) <= 8e-3


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
