"""The plain versions of whisper_tpu_torch's kernels against whisper_tpu.

K1 (encoder attention): ``attention_plain`` against ``attention_pallas``'s
real body under ``force_tpu_interpret_mode`` at both head dims the kernel
takes (64 and 128), and against ``qkv_attention``, the oracle the JAX
encoder takes off the TPU.  K2 (fused decode step): the port's step against
``decoder_step`` and against ``decoder_step_fused`` with the real Pallas
kernel body under the interpreter, at tests/test_fused_step.py's DIMS and
bounds.  On a CPU tensor each wrapper takes its plain version and counts no
launch; the kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import whisper_tpu.models.whisper as jw
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.ops.attention import qkv_attention
from whisper_tpu.ops.kernels.attention_pallas import attention_pallas
from whisper_tpu.ops.kernels.fused_step_pallas import pack_fused_weights, pad_cross_kv

import whisper_tpu_torch.models.whisper as tw
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.load import params_from_numpy
from whisper_tpu_torch.ops.kernels import attention as k1
from whisper_tpu_torch.ops.kernels import fused_step as k2
from whisper_tpu_torch.quantize import Int8Weight

torch.set_num_threads(2)

# tests/test_fused_step.py's DIMS: head_dim 64, as the CUDA kernels take
KW = dict(
    n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
    n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_state=128,
    n_text_head=2, n_text_layer=3,
)
DIMS, JDIMS = ModelDimensions(**KW), JDims(**KW)


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def pinned_numerics():
    """What an earlier test in the same worker could leave behind and a
    float32 comparison could inherit, pinned for the test: torch's thread
    count and float32 matmul precision, and JAX's default dot precision."""
    threads, precision = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_num_threads(threads)
        torch.set_float32_matmul_precision(precision)


# -- K1 ---------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,dtype,atol",
    [
        # f32: the same function, summed in another order
        ((2, 2, 1500, 64), "float32", 1e-5),
        ((1, 3, 1500, 32), "float32", 1e-5),
        ((2, 3, 100, 64), "float32", 1e-5),
        # bf16: the kernel's deferred normalisation rounds the exp weights
        # before the divide (attention_pallas.py:42-49), qkv_attention after
        ((2, 2, 1500, 64), "bfloat16", 2e-2),
        ((1, 3, 1500, 32), "bfloat16", 2e-2),
        ((2, 3, 100, 64), "bfloat16", 2e-2),
    ],
)
def test_k1_plain_matches_qkv_attention(shape, dtype, atol, pinned_numerics):
    """The f32 cases sum 1500-term products in another order (errors about
    4e-7); the state an earlier test could leave in the process is pinned
    (``pinned_numerics``), the JAX reference is complete before the port
    runs, and a failure names the side that moved, against float64."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref, _ = qkv_attention(*(jnp.asarray(a, jd) for a in (q, k, v)))
    ref = np.asarray(jax.block_until_ready(ref), np.float32)
    launches = k1.attention.launches
    got = k1.attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)))
    assert k1.attention.launches == launches  # a CPU tensor launches nothing
    assert got.dtype == td and got.shape == shape
    got = got.float().numpy()
    err = np.abs(got - ref).max()
    if err > atol:
        s = q.astype(np.float64) @ k.astype(np.float64).swapaxes(-1, -2) / np.sqrt(shape[-1])
        p = np.exp(s - s.max(-1, keepdims=True))
        exact = (p @ v.astype(np.float64)) / p.sum(-1, keepdims=True)
        pytest.fail(f"port - qkv_attention {err:.3e} > {atol}: port - float64 "
                    f"{np.abs(got - exact).max():.3e}, qkv_attention - float64 {np.abs(ref - exact).max():.3e}")


@pytest.mark.parametrize(
    "shape,dtype,atol",
    [
        # f32: the same function, summed in another order
        ((1, 2, 300, 128), "float32", 1e-5),
        ((1, 2, 300, 64), "float32", 1e-5),
        ((2, 1, 130, 128), "float32", 1e-5),
        # bf16: the same rounding points (exp weights rounded before PV, the
        # denominator from them); only the f32 sums' order differs, which
        # may move an exp weight to a neighbouring bf16 value
        ((1, 2, 300, 128), "bfloat16", 1e-2),
        ((1, 2, 300, 64), "bfloat16", 1e-2),
    ],
)
def test_k1_plain_matches_the_pallas_body(shape, dtype, atol):
    """T = 300 and 130 leave a ragged last 128-row query block, which the
    Pallas kernel masks on store."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = attention_pallas(*(jnp.asarray(a, jd) for a in (q, k, v)))
    got = k1.attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)))
    assert got.dtype == td and got.shape == shape
    assert np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max() <= atol


def test_encoder_attention_dispatches_on_the_head_dim():
    """ops.attention.encoder_attention follows whisper_tpu's rule: head dims
    64 and 128 take K1 (its plain version on a CPU tensor), any other takes
    qkv_attention."""
    from whisper_tpu_torch.ops import attention as tattn

    rng = np.random.RandomState(3)
    for d in (32, 64, 128):
        q, k, v = (torch.from_numpy(rng.randn(1, 2, 40, d).astype(np.float32)) for _ in range(3))
        want = k1.attention_plain(q, k, v) if d in k1.HEAD_DIMS else tattn.qkv_attention(q, k, v)[0]
        torch.testing.assert_close(tattn.encoder_attention(q, k, v), want, rtol=0, atol=0)
    assert k1.HEAD_DIMS == (64, 128)


def test_k1_plain_masks_nothing_at_an_odd_length():
    """T = 1500 is not a multiple of the kernel's tiles; the plain version,
    its reference, must equal an explicit softmax at any length."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(1, 1, 37, 64).astype(np.float32)) for _ in range(3))
    s = (q * 64**-0.25) @ (k * 64**-0.25).transpose(-1, -2)
    ref = torch.softmax(s, dim=-1) @ v
    torch.testing.assert_close(k1.attention_plain(q, k, v), ref, rtol=0, atol=1e-6)


K1_BKN = 128  # keys per tile of csrc/attention.cu's bf16 kernel (its BKN)


def _k1_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bkn: int) -> torch.Tensor:
    """The bf16 wgmma kernel's blocking in plain torch, (B, H, T, D) ->
    (B, H, T, D): f32 scores of the bf16 q and k, key tiles of bkn, a
    running max in log2 units (D^-0.5 log2(e) folded into one scale), exp2
    weights rounded to bf16 per tile against that running max, the f32
    denominator summed from the rounded weights, O rescaled per tile, the
    divide at the end."""
    c = q.shape[-1] ** -0.5 * 1.4426950408889634
    s_all = torch.matmul(q.float(), k.float().transpose(-1, -2))
    rows = q.shape[:-1]
    m = torch.full(rows, -float("inf"))
    l, o = torch.zeros(rows), torch.zeros(q.shape)
    for k0 in range(0, q.shape[-2], bkn):
        s = s_all[..., k0:k0 + bkn]
        m_new = torch.maximum(m, s.amax(dim=-1) * c)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None]).to(torch.bfloat16).float()
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.matmul(p, v[..., k0:k0 + bkn, :].float())
        m = m_new
    return (o / l[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [1500, 577, 129, 100, 1])
def test_k1_kernel_blocking_keeps_the_pallas_numerics(t, d):
    """The card kernel's key tiling (K1_BKN keys) and per-tile rounding of
    the weights against the TPU kernel's body under the interpreter, which
    rounds once against the row's exact max, two heads in bf16: K1's bf16
    bounds on the card (relative RMS 5e-3, max 1e-2) hold at every length
    the card tests take, whole tiles, ragged ones and one key."""
    rng = np.random.RandomState(5 + d + t)
    q, k, v = (rng.randn(1, 2, t, d).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(attention_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))), np.float32)
    got = _k1_blocked(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), K1_BKN).float().numpy()
    diff = got - ref
    assert np.linalg.norm(diff) <= 5e-3 * np.linalg.norm(ref)
    assert np.abs(diff).max() <= 1e-2 * np.abs(ref).max()


# -- K2 ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return jw.init_params(JDIMS, jax.random.PRNGKey(0), jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), DIMS)


@pytest.fixture(scope="module")
def step_inputs(jparams):
    """Cross K/V from random features, and a self cache filled below t0."""
    rng = np.random.RandomState(0)
    feats = jnp.asarray(rng.randn(1, 1500, 128) * 0.3, jnp.float32)
    xk, xv = jw.compute_cross_kv(jparams, JDIMS, feats)
    T, t0 = 64, 7
    shape = (DIMS.n_text_layer, 1, DIMS.n_text_head, 64, T)
    rng = np.random.RandomState(1)
    sk = rng.randn(*shape).astype(np.float32) * 0.1
    sv = rng.randn(*shape).astype(np.float32) * 0.1
    sk[..., t0:] = 0
    sv[..., t0:] = 0
    return np.array(xk), np.array(xv), sk, sv, t0


def _jax_cache(step_inputs):
    xk, xv, sk, sv, _ = step_inputs
    return jw.KVCache(*(jnp.asarray(a) for a in (sk, sv, xk, xv)))


def _torch_cache(step_inputs):
    xk, xv, sk, sv, _ = step_inputs
    return tw.KVCache(*(torch.from_numpy(a.copy()) for a in (sk, sv, xk, xv)))


@pytest.mark.parametrize("oracle", ["decoder_step", "decoder_step_fused_interpret"])
def test_k2_step_matches_jax(jparams, tparams, step_inputs, oracle):
    """hidden: atol 3e-5, rtol 1e-4; cache columns: atol 1e-5 — the bounds
    of tests/test_fused_step.py."""
    t0 = step_inputs[-1]
    tokens = jnp.asarray([42], jnp.int32)
    cache = _jax_cache(step_inputs)
    if oracle == "decoder_step":
        ref_h, ref_cache = jw.decoder_step(jparams, JDIMS, tokens, jnp.int32(t0), cache)
    else:
        pack = pack_fused_weights(jparams, JDIMS)
        xkp, xvp, xks, xvs = pad_cross_kv(cache.cross_k, cache.cross_v)
        ref_h, ref_cache = jw.decoder_step_fused(
            jparams, pack, JDIMS, tokens, jnp.int32(t0), cache, xkp, xvp, xks, xvs
        )

    h, tcache = tw.decoder_step(tparams, DIMS, torch.tensor([42]), t0, _torch_cache(step_inputs))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(tcache.self_k.numpy(), np.asarray(ref_cache.self_k), atol=1e-5)
    np.testing.assert_allclose(tcache.self_v.numpy(), np.asarray(ref_cache.self_v), atol=1e-5)


def test_k2_plain_layers_contract(tparams, step_inputs):
    """The plain version's outputs: hidden (B, C) before the final
    LayerNorm, and the new K/V (L, B, C) that land in cache column t."""
    t0 = step_inputs[-1]
    cache = _torch_cache(step_inputs)
    x = tw._embed_step(tparams, DIMS, torch.tensor([42]), t0)
    hidden, k_new, v_new = k2.fused_decoder_layers(
        tparams["decoder"]["blocks"], DIMS.n_text_head, x, t0, *cache
    )
    L, C = DIMS.n_text_layer, DIMS.n_text_state
    assert hidden.shape == (1, C) and k_new.shape == v_new.shape == (L, 1, C)
    h2, cache2 = tw.decoder_step(tparams, DIMS, torch.tensor([42]), t0, _torch_cache(step_inputs))
    dec = tparams["decoder"]
    torch.testing.assert_close(tw.layer_norm(hidden, dec["ln_g"], dec["ln_b"]), h2)
    torch.testing.assert_close(cache2.self_k[..., t0], k_new.view(L, 1, 2, 64))
    torch.testing.assert_close(cache2.self_v[..., t0], v_new.view(L, 1, 2, 64))


def test_k2_step_past_capacity_drops_the_write(tparams, step_inputs):
    """A position at the cache's capacity attends the whole cache and its
    K/V write is dropped, as whisper_tpu's step does."""
    cache = _torch_cache(step_inputs)
    before = cache.self_k.clone()
    T = cache.self_k.shape[-1]
    launches = k2.fused_decoder_layers.launches
    h, cache = tw.decoder_step_fused(tparams, DIMS, torch.tensor([7]), T, cache)
    assert k2.fused_decoder_layers.launches == launches  # a CPU tensor launches nothing
    assert torch.isfinite(h).all()
    torch.testing.assert_close(cache.self_k, before, rtol=0, atol=0)


def test_k2_wrapper_refuses_other_devices(tparams, step_inputs):
    cache = _torch_cache(step_inputs)
    x = torch.zeros(1, DIMS.n_text_state, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k2.fused_decoder_layers(tparams["decoder"]["blocks"], 2, x, 3, *cache)
    with pytest.raises(ValueError, match="unsupported device"):
        k1.attention(*(torch.zeros(1, 2, 8, 64, device="meta") for _ in range(3)))


def test_k2_grouped_step_matches_jax(jparams, tparams, step_inputs):
    """A beam group of G = 5 rows with distinct histories (each row its own
    self cache and token) against decoder_step(..., n_group=5), which folds
    the group into the query axis of one shared cross K/V: hidden atol 3e-5,
    rtol 1e-4; cache columns atol 1e-5."""
    xk, xv, _, _, t0 = step_inputs
    G = 5
    rng = np.random.RandomState(2)
    shape = (DIMS.n_text_layer, G, DIMS.n_text_head, 64, 64)
    sk = (rng.randn(*shape) * 0.1).astype(np.float32)
    sv = (rng.randn(*shape) * 0.1).astype(np.float32)
    sk[..., t0:] = 0
    sv[..., t0:] = 0
    tokens = np.array([42, 7, 1999, 50257, 311])

    cache = jw.KVCache(*(jnp.asarray(a) for a in (sk, sv, xk, xv)))
    ref_h, ref_cache = jw.decoder_step(
        jparams, JDIMS, jnp.asarray(tokens, jnp.int32), jnp.int32(t0), cache, n_group=G
    )
    tcache = tw.KVCache(*(torch.from_numpy(a.copy()) for a in (sk, sv, xk, xv)))
    assert tcache.cross_k.shape[1] == 1  # one audio's cross K/V for the whole group
    h, tcache = tw.decoder_step_fused(tparams, DIMS, torch.from_numpy(tokens), t0, tcache)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(tcache.self_k.numpy(), np.asarray(ref_cache.self_k), atol=1e-5)
    np.testing.assert_allclose(tcache.self_v.numpy(), np.asarray(ref_cache.self_v), atol=1e-5)


# -- K2's row slices (more than 128 rows) -------------------------------------


@pytest.mark.parametrize("audios,G", [(160, 1), (32, 5), (27, 5), (128, 1), (3, 5), (1, 128)])
def test_k2_row_slices_hold_whole_audios(audios, G):
    """Each launch holds at most 128 rows of whole audios, as many as fit,
    in order; together they cover every row and audio once."""
    rows = audios * G
    slices = k2.row_slices(rows, audios)
    assert slices[0][0][0] == 0 and slices[-1][0][1] == rows and slices[-1][1][1] == audios
    for i, ((r0, r1), (a0, a1)) in enumerate(slices):
        assert 0 < r1 - r0 <= k2.MAX_ROWS and (r0, r1) == (a0 * G, a1 * G)
        if i + 1 < len(slices):
            assert slices[i + 1][0][0] == r1 and r1 - r0 == (k2.MAX_ROWS // G) * G
    assert len(slices) == -(-audios // (k2.MAX_ROWS // G))


@pytest.mark.parametrize("audios,G", [(1, 129), (1, 200), (2, 200), (3, 300)])
def test_k2_row_slices_split_a_group_wider_than_a_launch(audios, G):
    """A group wider than 128 rows is cut into ceil(G / 128) launches of
    its one audio, as even as they go, in order; together they cover every
    row once.  Rows that audios do not divide raise."""
    rows, parts = audios * G, -(-G // k2.MAX_ROWS)
    slices = k2.row_slices(rows, audios)
    assert len(slices) == audios * parts
    end = 0
    for i, ((r0, r1), (a0, a1)) in enumerate(slices):
        assert r0 == end and 0 < r1 - r0 <= k2.MAX_ROWS and a1 == a0 + 1 == i // parts + 1
        assert a0 * G <= r0 < r1 <= a1 * G and r1 - r0 in (G // parts, -(-G // parts))
        end = r1
    assert end == rows
    with pytest.raises(ValueError, match="divide"):
        k2.row_slices(10, 3)


@pytest.mark.parametrize("A,G", [(27, 5), (1, 129), (1, 200), (2, 150)])
@pytest.mark.parametrize("pending", [False, True])
def test_k2_step_in_row_slices_equals_the_whole(A, G, pending):
    """A audios of G rows at per-row positions (27 x 5 = 135 rows in slices
    of whole audios; 129, 200 and 2 x 150 rows in parts of one audio's
    group), per step and with a pending block: the plain step run slice by
    slice, on each slice's rows, cache rows and audios, equals the step of
    all rows at once: a slice holds every input its rows read."""
    gen = torch.Generator().manual_seed(0)
    L, C, H, T, Ta, W = 1, 64, 1, 8, 16, 4
    B = A * G

    def randn(*shape, scale=0.1):
        return torch.randn(shape, generator=gen) * scale

    sizes = {"fc1_w": (4 * C, C), "fc2_w": (C, 4 * C), "fc1_b": (4 * C,)}
    blocks = {n: randn(L, *sizes.get(n, (C, C) if n.endswith("_w") else (C,))) for n in k2.WEIGHTS}
    x, t = randn(B, C), torch.randint(0, T + 1, (B,), generator=gen)
    sk, sv, xk, xv = randn(L, B, H, 64, T), randn(L, B, H, 64, T), randn(L, A, H, 64, Ta), randn(L, A, H, 64, Ta)
    pk, pv = randn(L, B, H, 64, W), randn(L, B, H, 64, W)

    def step(rows, audios):
        pend = (pk[:, rows], pv[:, rows], 3) if pending else ()
        return k2.fused_decoder_layers(blocks, H, x[rows], t[rows], sk[:, rows], sv[:, rows], xk[:, audios],
                                       xv[:, audios], *pend)

    whole = step(slice(None), slice(None))
    parts = [step(slice(r0, r1), slice(a0, a1)) for (r0, r1), (a0, a1) in k2.row_slices(B, A)]
    torch.testing.assert_close(torch.cat([p[0] for p in parts]), whole[0], rtol=0, atol=1e-6)
    for i in (1, 2):
        torch.testing.assert_close(torch.cat([p[i] for p in parts], dim=1), whole[i], rtol=0, atol=1e-6)


def test_k2_takes_the_published_shapes_and_the_engine_routes_the_rest():
    """F4: the engine picks its step by the decoder's shape once per decode
    (``engine.decoder_steps``), as whisper_tpu's ``_fused_ok``: K2's step
    for head dim 64 (every published model, bf16 up to width 2048), the
    PyTorch step otherwise; and K2's own check still refuses a head dim of
    32 (the tests' tiny dims)."""
    from whisper_tpu_torch import engine
    from whisper_tpu_torch.models.dims import KNOWN_MODELS

    fused = (tw.decoder_step_fused, tw.decoder_step_fused_pending)
    plain = (tw.decoder_step, tw.decoder_step_pending)
    for name, dims in KNOWN_MODELS.items():
        assert k2.takes(dims.n_text_head, dims.n_text_state, torch.bfloat16), name
    tiny = ModelDimensions(**{**KW, "n_text_state": 64, "n_text_head": 2})
    for dims, dtype, rows, want in ((DIMS, torch.float32, DIMS.n_text_state, fused),
                                    (DIMS, torch.bfloat16, DIMS.n_text_state, fused),
                                    (tiny, torch.float32, tiny.n_text_state, plain),
                                    # a model shard (parallel.shard_params): its q_w holds
                                    # half the heads' rows, and the PyTorch step runs
                                    (DIMS, torch.bfloat16, DIMS.n_text_state // 2, plain)):
        params = {"decoder": {"tok_emb": torch.zeros(1, dims.n_text_state, dtype=dtype),
                              "blocks": {"q_w": torch.zeros(1, rows, dims.n_text_state, dtype=dtype)}}}
        assert engine.decoder_steps(params, dims) == want
    assert not k2.takes(16, 2048 + 64 * 16, torch.bfloat16) and k2.takes(48, 3072, torch.float32)
    assert not k2.takes(20, 1300, torch.float32) and not k2.takes(2, 128, torch.float16)

    L, B, H, D, C = 1, 2, 2, 32, 64
    blocks = {n: torch.zeros(L, *((4 * C, C) if n == "fc1_w" else (C, 4 * C) if n == "fc2_w"
                                  else (4 * C,) if n == "fc1_b" else (C, C) if n.endswith("_w") else (C,)))
              for n in k2.WEIGHTS}
    caches = [torch.zeros(L, B, H, D, 8), torch.zeros(L, B, H, D, 8), torch.zeros(L, 1, H, D, 16),
              torch.zeros(L, 1, H, D, 16)]
    with pytest.raises(ValueError, match="unsupported"):
        k2._check_args(blocks, H, torch.zeros(B, C), None, *caches, None, None, 0)


# -- K2's decode-attention blocking (csrc/fused_step.cu) ----------------------

# csrc/fused_step.cu: keys per tile, blocks per (row, head) at most, the
# keys per block the split aims at in self- and cross-attention, and the
# blocks it may start per SM of an H100 (132)
K2_TK, K2_MAX_SPLIT, K2_SELF_KEYS, K2_CROSS_KEYS, K2_ROOM = 64, 8, 128, 192, 2 * 132
K2_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # the card's bounds (tests/test_torch_cuda.py)


def _k2_split(n_max: int, keys_per_block: int, units: int) -> int:
    """attention_launch's split for a launch of `units` (group, head) pairs."""
    return min(K2_MAX_SPLIT, max(1, min(K2_ROOM // units, -(-n_max // keys_per_block))))


def _k2_blocked(q, k, v, n, split, scale, cdtype, ks=None, vs=None, extras=()):
    """decode_attention_kernel for one (query group, head) in plain torch,
    (NQ, D): q (NQ, D), k and v (D, T) of which the first n keys count,
    split blocks of chunk = ceil(n / split) keys rounded up to whole tiles
    of K2_TK; each block's scores tile by tile (eighth e of D the rows d =
    8 i + e, added ((e0 + e1) + (e2 + e3)) + ((e4 + e5) + (e6 + e7))), its
    max and its sum of exp(s - max); the exact max and
    denominator from the blocks' pairs in rank order; every weight
    normalised and rounded to cdtype before PV; the blocks' partial outputs
    summed in rank order.  extras (rank 0): (key, value) pairs of D, the
    pending columns and then the new token.  int8 K/V (ks, vs: the scales):
    the scales fold into q, the keys enter unscaled, PV times vs."""
    rnd = lambda a: a.to(cdtype).float()  # noqa: E731
    D = q.shape[-1]
    qs = rnd(q.float() * scale * (ks if ks is not None else 1.0))
    kf = k.float() if ks is not None else rnd(k.float() * scale)
    chunk = -(-(-(-n // split)) // K2_TK) * K2_TK
    blocks = []
    for rank in range(split):
        t0 = min(n, rank * chunk)
        t1 = min(n, t0 + chunk)
        tiles = []
        for k0 in range(t0, t1, K2_TK):
            tile = kf[:, k0:min(t1, k0 + K2_TK)]
            e = [qs[:, i::8] @ tile[i::8] for i in range(8)]
            tiles.append(((e[0] + e[1]) + (e[2] + e[3])) + ((e[4] + e[5]) + (e[6] + e[7])))
        s = torch.cat(tiles, dim=1) if tiles else qs.new_zeros((qs.shape[0], 0))
        if rank == 0 and extras:
            s_ex = torch.stack([(qs * rnd(ke.float() * scale)).sum(dim=1) for ke, _ in extras], dim=1)
        else:
            s_ex = qs.new_zeros((qs.shape[0], 0))
        both = torch.cat([s, s_ex], dim=1)
        m = both.amax(dim=1) if both.shape[1] else torch.full((qs.shape[0],), -float("inf"))
        l = torch.exp(both - m[:, None]).sum(dim=1) if both.shape[1] else torch.zeros(qs.shape[0])
        blocks.append((t0, t1, s, s_ex, m, l))
    mx = torch.stack([b[4] for b in blocks]).amax(dim=0)
    denom = torch.zeros_like(mx)
    for *_, m, l in blocks:
        denom = denom + torch.where(m > -float("inf"), l * torch.exp(m - mx), 0.0)
    out = torch.zeros_like(qs)
    for t0, t1, s, s_ex, _, _ in blocks:
        p = rnd(torch.exp(s - mx[:, None]) / denom[:, None])
        out = out + p @ v[:, t0:t1].float().t()
    if extras:
        p_ex = rnd(torch.exp(blocks[0][3] - mx[:, None]) / denom[:, None])
        for e, (_, ve) in enumerate(extras):
            out = out + p_ex[:, e:e + 1] * ve.float()[None]
    if vs is not None:
        out = out * vs
    return out.to(cdtype)


def _k2_self_blocked(q, k_new, v_new, self_k, self_v, t, pend_k=None, pend_v=None, pend_w=0):
    """k2._self_attention through _k2_blocked: one (row, head) at a time,
    the split from the launch's largest key count (t shared, else T)."""
    B, H, _, D = q.shape
    T = self_k.shape[-1]
    split = _k2_split(t if isinstance(t, int) else T, K2_SELF_KEYS, B * H)
    out = torch.empty_like(q)
    for b in range(B):
        n = min(max(int(t if isinstance(t, int) else t[b]), 0), T)
        for h in range(H):
            extras = [(pend_k[b, h, :, e], pend_v[b, h, :, e]) for e in range(pend_w)] if pend_k is not None else []
            extras.append((k_new[b, h, 0], v_new[b, h, 0]))
            out[b, h, 0] = _k2_blocked(q[b, h], self_k[b, h], self_v[b, h], n, split, D ** -0.25, q.dtype,
                                       extras=extras)
    return out


def _k2_cross_blocked(xq, cross_k, cross_v):
    """k2._cross_attention through _k2_blocked: the largest NQ <= 8 rows of
    an audio that divides G share each (audio, head)'s blocks."""
    B, H, _, D = xq.shape
    int8 = isinstance(cross_k, Int8Weight)
    xk, xv = (cross_k.q, cross_v.q) if int8 else (cross_k, cross_v)
    A, Ta = xk.shape[0], xk.shape[-1]
    G = B // A
    per = max(d for d in range(1, 9) if G % d == 0)
    split = _k2_split(Ta, K2_CROSS_KEYS, B // per * H)
    out = torch.empty_like(xq)
    for a in range(A):
        for g0 in range(a * G, (a + 1) * G, per):
            for h in range(H):
                ks = cross_k.s[a, h, :, 0] if int8 else None
                vs = cross_v.s[a, h, :, 0] if int8 else None
                out[g0:g0 + per, h, 0] = _k2_blocked(xq[g0:g0 + per, h, 0], xk[a, h], xv[a, h], Ta, split,
                                                     D ** (-0.5 if int8 else -0.25), xq.dtype, ks, vs)
    return out


@pytest.fixture(scope="module")
def k2_packs(jparams):
    """whisper_tpu's fused-step weight pack per compute dtype."""
    packs = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        p = jax.tree.map(lambda a: a.astype(dt) if a.dtype == jnp.float32 else a, jparams)
        packs[name] = pack_fused_weights(p, JDIMS)
    return packs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["plain", "int8"])
@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("pend_w", [None, 0, 3, 8])
@pytest.mark.parametrize("t", [0, 1, 127, 200, 256])
def test_k2_attention_blocking_keeps_the_pallas_numerics(k2_packs, tparams, monkeypatch, dtype, kv, G, pend_w,
                                                          t):
    """The card's decode-attention blocking (64-key tiles, the split by key
    count: one or two blocks of self-attention at t_cap = 256, eight of
    cross-attention at Ta = 1500; each block's max and sum exchanged once;
    weights normalised and rounded before PV; rank 0 taking the pending
    columns and the new token) in the port's plain step, against
    whisper_tpu's fused step (the Pallas kernel under the interpreter, as
    tests/test_fused_step.py runs it) on the same inputs: hidden, k_new and
    v_new within K2's bounds on the card.  pend_w None: no pending block; a
    block of 8 columns otherwise.  G = 5 with a block: the Pallas kernel
    takes pending blocks for one row or one row per audio, so there it runs
    five audios holding the same K/V."""
    from whisper_tpu.ops.kernels.fused_step_pallas import fused_decoder_layers as pallas_layers
    from whisper_tpu.quantize import quantize_kv as jax_quantize_kv

    L, H, C, T, Ta, W = DIMS.n_text_layer, DIMS.n_text_head, DIMS.n_text_state, 256, 1500, 8
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.RandomState(11 + t + 3 * G + (pend_w or 0))
    x = rng.randn(G, C).astype(np.float32) * 0.5
    sk, sv = (rng.randn(L, G, H, 64, T).astype(np.float32) for _ in range(2))
    xk, xv = (rng.randn(L, 1, H, 64, Ta).astype(np.float32) for _ in range(2))
    pk, pv = (rng.randn(L, G, H, 64, W).astype(np.float32) for _ in range(2))

    pack = k2_packs[dtype]
    jx, jsk, jsv = (jnp.asarray(a, jdt) for a in (x, sk, sv))
    jxk, jxv = jnp.asarray(xk, jdt), jnp.asarray(xv, jdt)
    pending = pend_w is not None
    if pending and G > 1:  # one audio per row: five copies of the one K/V
        jxk, jxv = jnp.repeat(jxk, G, axis=1), jnp.repeat(jxv, G, axis=1)
    if kv == "int8":
        jxk, jxv = jax_quantize_kv(jxk), jax_quantize_kv(jxv)
    xkp, xvp, xks, xvs = pad_cross_kv(jxk, jxv)
    extra = (jnp.asarray(pk, jdt), jnp.asarray(pv, jdt), jnp.int32(pend_w)) if pending else ()
    ref = pallas_layers(pack, JDIMS, jx, jnp.full((G,), t, jnp.int32), jsk, jsv, xkp, xvp, xks, xvs, *extra)

    blocks = {n: w.to(tdt) for n, w in tparams["decoder"]["blocks"].items()}
    txk, txv = torch.from_numpy(xk).to(tdt), torch.from_numpy(xv).to(tdt)
    if kv == "int8":
        quant = [jax_quantize_kv(jnp.asarray(a, jdt)) for a in (xk, xv)]
        txk, txv = (Int8Weight(torch.from_numpy(np.array(d["q"])), torch.from_numpy(np.array(d["s"])))
                    for d in quant)
    args = [blocks, H, torch.from_numpy(x).to(tdt), t, torch.from_numpy(sk).to(tdt),
            torch.from_numpy(sv).to(tdt), txk, txv]
    if pending:
        args += [torch.from_numpy(pk).to(tdt), torch.from_numpy(pv).to(tdt), pend_w]
    monkeypatch.setattr(k2, "_self_attention", _k2_self_blocked)
    monkeypatch.setattr(k2, "_cross_attention", _k2_cross_blocked)
    got = k2.fused_decoder_layers_plain(*args)
    for a, b in zip(got, ref):
        b = np.asarray(b, np.float32)
        rel = np.abs(a.float().numpy() - b).max() / np.abs(b).max()
        assert rel <= K2_REL_TOL[dtype], rel
