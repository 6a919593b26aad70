"""The plain versions of whisper_tpu_torch's kernels against whisper_tpu.

K1 (encoder attention): ``attention_plain`` against ``qkv_attention``, the
oracle the JAX encoder takes off the TPU (``attention_pallas`` has no
interpret switch).  K2 (fused decode step): the port's step against
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

import whisper_tpu.models.whisper as jw
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.ops.attention import qkv_attention
from whisper_tpu.ops.kernels.fused_step_pallas import pack_fused_weights, pad_cross_kv

import whisper_tpu_torch.models.whisper as tw
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.load import params_from_numpy
from whisper_tpu_torch.ops.kernels import attention as k1
from whisper_tpu_torch.ops.kernels import fused_step as k2

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
def test_k1_plain_matches_qkv_attention(shape, dtype, atol):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref, _ = qkv_attention(*(jnp.asarray(a, jd) for a in (q, k, v)))
    launches = k1.attention.launches
    got = k1.attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)))
    assert k1.attention.launches == launches  # a CPU tensor launches nothing
    assert got.dtype == td and got.shape == shape
    err = np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max()
    assert err <= atol


def test_k1_plain_masks_nothing_at_an_odd_length():
    """T = 1500 is not a multiple of the kernel's tiles; the plain version,
    its reference, must equal an explicit softmax at any length."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(1, 1, 37, 64).astype(np.float32)) for _ in range(3))
    s = (q * 64**-0.25) @ (k * 64**-0.25).transpose(-1, -2)
    ref = torch.softmax(s, dim=-1) @ v
    torch.testing.assert_close(k1.attention_plain(q, k, v), ref, rtol=0, atol=1e-6)


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
