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
