"""K5, the decoder MLP of a decode step, against whisper_tpu's Pallas kernel.

``mlp_fused_plain`` (and the wrapper, which takes it for a CPU tensor)
against ``mlp_fused_pallas(..., interpret=True)`` as tests/test_mlp_kernel.py
runs it, on the same numpy-seeded inputs in float32, unquantized and with
whisper_tpu's int8 weights carried over value for value.  Tolerance: rtol
and atol 2e-5, tests/test_mlp_kernel.py's own, which covers the TPU
kernel's A&S erf (1.5e-7 absolute) against the exact erf here.  K2's plain
step runs the same function for its MLP stage.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops.kernels.mlp_pallas import mlp_fused_pallas
from whisper_tpu.quantize import quantize_weight

from whisper_tpu_torch.ops.kernels import fused_step as k2
from whisper_tpu_torch.ops.kernels import mlp as k5
from whisper_tpu_torch.quantize import Int8Weight

torch.set_num_threads(2)


def _inputs(B: int, C: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return dict(
        x=(rng.randn(B, C) * 0.5).astype(np.float32),
        g=(1 + rng.randn(C) * 0.1).astype(np.float32),
        b=(rng.randn(C) * 0.1).astype(np.float32),
        w1=(rng.randn(C, 4 * C) * 0.05).astype(np.float32),  # whisper_tpu's (in, out)
        b1=(rng.randn(4 * C) * 0.1).astype(np.float32),
        w2=(rng.randn(4 * C, C) * 0.05).astype(np.float32),
        b2=(rng.randn(C) * 0.1).astype(np.float32),
    )


def _port_weight(w):
    """A whisper_tpu weight, array or int8 dict, in the port's (out, in)."""
    if isinstance(w, dict):
        return Int8Weight(*(torch.from_numpy(np.swapaxes(np.asarray(w[k]), 0, 1).copy()) for k in ("q", "s")))
    return torch.from_numpy(np.swapaxes(np.asarray(w), 0, 1).copy())


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_mlp_fused_matches_the_pallas_kernel(B, quantized):
    C = 256
    a = _inputs(B, C)
    w1, w2 = jnp.asarray(a["w1"]), jnp.asarray(a["w2"])
    if quantized:
        w1, w2 = quantize_weight(w1), quantize_weight(w2)
    ref = np.asarray(mlp_fused_pallas(
        jnp.asarray(a["x"]), jnp.asarray(a["g"]), jnp.asarray(a["b"]), w1, jnp.asarray(a["b1"]),
        w2, jnp.asarray(a["b2"]), bk=256, interpret=True,
    ))
    args = (torch.from_numpy(a["x"]), torch.from_numpy(a["g"]), torch.from_numpy(a["b"]),
            _port_weight(w1), torch.from_numpy(a["b1"]), _port_weight(w2), torch.from_numpy(a["b2"]))
    launches = k5.mlp_fused.launches
    got = k5.mlp_fused(*args)
    assert k5.mlp_fused.launches == launches  # a CPU tensor launches nothing
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(k5.mlp_fused_plain(*args), got, rtol=0, atol=0)


def test_k2_plain_runs_k5s_function_for_its_mlp_stage(monkeypatch):
    """The plain decode step's MLP stage is mlp_fused_plain, once per layer,
    with that layer's weights."""
    calls = []
    real = k2.mlp_fused_plain

    def spy(x, *args):
        calls.append(x.shape)
        return real(x, *args)

    monkeypatch.setattr(k2, "mlp_fused_plain", spy)
    L, B, C, H, T = 3, 2, 128, 2, 8
    gen = torch.Generator().manual_seed(0)
    shapes = {"fc1_w": (4 * C, C), "fc2_w": (C, 4 * C), "fc1_b": (4 * C,)}
    blocks = {n: torch.randn((L, *shapes.get(n, (C, C) if n.endswith("_w") else (C,))), generator=gen) * 0.02
              for n in k2.WEIGHTS}
    caches = [torch.randn((L, B, H, 64, T), generator=gen) for _ in range(2)]
    caches += [torch.randn((L, 1, H, 64, 16), generator=gen) for _ in range(2)]
    k2.fused_decoder_layers(blocks, H, torch.randn((B, C), generator=gen), 3, *caches)
    assert calls == [(B, 1, C)] * L


def test_mlp_fused_refuses_other_devices():
    x = torch.zeros(1, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k5.mlp_fused(x, x[0], x[0], x, None, x, None)


# -- K5's blocking on the card (csrc/fused_step.cu mlp_stream_kernel) ---------

# csrc/fused_step.cu: a weight box's width in bytes (64 bf16 or 128 int8
# columns), the chunks a stage gives each consumer warp, and K2's bf16 bound
# on the card (tests/test_torch_cuda.py)
K5_BOX_BYTES, K5_STAGE_CHUNKS = 128, 2
K5_REL_TOL = 2e-2


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _k5_product(h, w, split):
    """mlp_stream_kernel's product h (rows, K) . w (N, K)^T in f32, in the
    kernel's order: the rows in tiles of 16 (n8 tiles of the mma's N side,
    zero-padded), the K chunks of one box's width split over `split` ranks
    in contiguous ranges equal to within one; in a rank, the k16 steps of
    chunk c (counted from the rank's first) summed into chain 2 (c % 2) +
    step % 2, the chains added (0 + 1) + (2 + 3); the ranks' parts added in
    rank order.  w holds bf16 values or int8 ones (converted exactly)."""
    rows, K = h.shape
    kc = K5_BOX_BYTES // (1 if w.dtype == torch.int8 else 2)
    wf = w.float()
    chunks = -(-K // kc)
    out = []
    for r0 in range(0, rows, 16):
        tile = h[r0:r0 + 16]
        tile = torch.cat([tile, tile.new_zeros((8 * -(-tile.shape[0] // 8) - tile.shape[0], K))])
        total = torch.zeros((tile.shape[0], w.shape[0]))
        for rank in range(split):
            c0 = rank * (chunks // split) + min(rank, chunks % split)
            nkc = chunks // split + (rank < chunks % split)
            chains = [torch.zeros_like(total) for _ in range(4)]
            for c in range(nkc):
                for step, k in enumerate(range((c0 + c) * kc, min(K, (c0 + c + 1) * kc), 16)):
                    chains[2 * (c % 2) + step % 2] += tile[:, k:k + 16] @ wf[:, k:k + 16].t()
            total = total + ((chains[0] + chains[1]) + (chains[2] + chains[3]))
        out.append(total[:min(16, rows - r0)])
    return torch.cat(out)


def _k5_blocked(x, g, b, w1, b1, w2, b2, split):
    """K5 on the card restated in torch: LayerNorm statistics in f32 (the
    mean, then the mean square deviation), the normalised row rounded to
    bf16; fc1 and fc2 by _k5_product; each epilogue rounds the product
    (times the int8 scale), then the bias, GELU and the residual."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(dim=1, keepdim=True) + 1e-5)
    h = _bf16((xf - mean) * rstd * g.float() + b.float())

    def linear(h, w, bias):
        q, s = (w.q, w.s[:, 0]) if isinstance(w, Int8Weight) else (w, 1.0)
        y = _bf16(_k5_product(h, q, split) * s)
        return y if bias is None else _bf16(y + bias.float())

    f = _bf16(torch.nn.functional.gelu(linear(h, w1, b1)))
    return _bf16(xf + linear(f, w2, b2))


@pytest.fixture(scope="module")
def k5_pallas_refs():
    """whisper_tpu's mlp_fused_pallas under the interpreter, bf16, per (rows,
    weights); computed once for the splits."""
    return {}


@pytest.mark.parametrize("B", [1, 5, 16, 17])
@pytest.mark.parametrize("weights", ["bf16", "int8"])
@pytest.mark.parametrize("split", [1, 2, 4])
def test_k5_blocking_keeps_the_pallas_numerics(k5_pallas_refs, B, weights, split):
    """The card's K5 blocking (weights as the mma's M side in tiles of 16
    rows, the rows in n8 tiles, each product's inputs split over `split`
    ranks whose parts meet in rank order, four chains of k16 steps in a
    warp) against whisper_tpu's Pallas kernel under the interpreter on the
    same numpy-seeded inputs in bf16, unquantized and with whisper_tpu's
    int8 weights carried over value for value: within K2's bf16 bound on
    the card."""
    C = 256
    a = _inputs(B, C, seed=3)
    key = (B, weights)
    jw1, jw2 = jnp.asarray(a["w1"], jnp.bfloat16), jnp.asarray(a["w2"], jnp.bfloat16)
    if weights == "int8":
        jw1, jw2 = quantize_weight(jw1), quantize_weight(jw2)
    if key not in k5_pallas_refs:
        k5_pallas_refs[key] = np.asarray(mlp_fused_pallas(
            jnp.asarray(a["x"], jnp.bfloat16), jnp.asarray(a["g"], jnp.bfloat16),
            jnp.asarray(a["b"], jnp.bfloat16), jw1, jnp.asarray(a["b1"], jnp.bfloat16), jw2,
            jnp.asarray(a["b2"], jnp.bfloat16), bk=256, interpret=True,
        ).astype(jnp.float32))
    ref = k5_pallas_refs[key]

    def port(w):
        if isinstance(w, dict):
            return Int8Weight(torch.from_numpy(np.swapaxes(np.asarray(w["q"]), 0, 1).copy()),
                              torch.from_numpy(np.swapaxes(np.asarray(w["s"], np.float32), 0, 1).copy()))
        return _bf16(torch.from_numpy(np.swapaxes(np.asarray(w.astype(jnp.float32)), 0, 1).copy()))

    t = {k: _bf16(torch.from_numpy(v)) for k, v in a.items()}
    got = _k5_blocked(t["x"], t["g"], t["b"], port(jw1), t["b1"], port(jw2), t["b2"], split)
    rel = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert rel <= K5_REL_TOL, rel
