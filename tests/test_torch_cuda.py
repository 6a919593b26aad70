"""whisper_tpu_torch's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import).  The file imports no JAX, so it runs on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances, the same as chip_smoke.py's.  K1 f32: max abs error 1e-5 on
outputs of unit scale.  K1 bf16: relative to the plain output, RMS error
5e-3 and max error 1e-2 of max |plain|; on an H100 the kernel reads at most
2.3e-3 and 5.2e-3 at these shapes, while a kernel that stops masking the
keys past T reads an RMS error of 1.45e-2 at T = 1500 and more at shorter
T.  K2: max error relative to max |plain| (f32 1e-4, bf16 2e-2).
"""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.ops.kernels import attention as k1
from whisper_tpu_torch.ops.kernels import fused_step as k2

pytestmark = pytest.mark.cuda

K1_F32_ATOL = 1e-5
K1_BF16_REL_RMS, K1_BF16_REL_MAX = 5e-3, 1e-2
K2_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape", [(1, 2, 1500, 64), (1, 4, 577, 64), (2, 3, 100, 64), (1, 1, 1, 64)]
)
def test_k1_kernel_matches_plain(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(3))
    launches = k1.attention.launches
    out = k1.attention(q, k, v)
    assert k1.attention.launches == launches + 1
    ref = k1.attention_plain(q, k, v)
    assert out.dtype == dtype and out.shape == shape
    diff, ref = out.float() - ref.float(), ref.float()
    if dtype == torch.float32:
        assert diff.abs().max().item() <= K1_F32_ATOL
    else:
        assert diff.norm().item() <= K1_BF16_REL_RMS * ref.norm().item()
        assert diff.abs().max().item() <= K1_BF16_REL_MAX * ref.abs().max().item()


def test_k1_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 2, 16, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        k1.attention(q, q, q)


def _k2_inputs(device, dtype, L=3, C=128, T=64, Ta=1500):
    gen = torch.Generator(device=device).manual_seed(0)
    H = C // 64

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    sizes = {"fc1_w": (4 * C, C), "fc2_w": (C, 4 * C), "fc1_b": (4 * C,)}
    blocks = {}
    for n in k2.WEIGHTS:
        shape = (L, *sizes.get(n, (C, C) if n.endswith("_w") else (C,)))
        blocks[n] = (1.0 + randn(*shape, scale=0.1)) if n.endswith("_g") else randn(*shape, scale=0.02)
    caches = [randn(L, 1, H, 64, T), randn(L, 1, H, 64, T), randn(L, 1, H, 64, Ta), randn(L, 1, H, 64, Ta)]
    return blocks, H, randn(1, C, scale=0.5), caches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [0, 7, 64])
def test_k2_kernel_matches_plain(cuda, dtype, t):
    blocks, H, x, caches = _k2_inputs(cuda, dtype)
    launches = k2.fused_decoder_layers.launches
    out = k2.fused_decoder_layers(blocks, H, x, t, *caches)
    assert k2.fused_decoder_layers.launches == launches + 1
    ref = k2.fused_decoder_layers_plain(blocks, H, x, t, *caches)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        rel = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
        assert rel <= K2_REL_TOL[dtype]


def test_k2_kernel_refuses_what_it_does_not_take(cuda):
    blocks, H, x, caches = _k2_inputs(cuda, torch.float32)
    with pytest.raises(ValueError, match="batch 1"):
        k2.fused_decoder_layers(blocks, H, x.repeat(2, 1), 3, *caches)
    with pytest.raises(ValueError, match="contiguous"):
        k2.fused_decoder_layers(blocks, H, x.to(torch.bfloat16), 3, *caches)


def test_greedy_path_runs_both_kernels(cuda):
    import whisper_tpu_torch
    from whisper_tpu_torch.decoding import DecodingOptions
    from whisper_tpu_torch.models import KNOWN_MODELS
    from whisper_tpu_torch.models.whisper import init_params

    dims = KNOWN_MODELS["tiny"]
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = whisper_tpu_torch.Whisper(dims, init_params(dims, gen, torch.bfloat16, cuda))
    mel = torch.from_numpy(np.random.RandomState(0).randn(80, 3000).astype(np.float32))
    k1.attention.launches = 0
    k2.fused_decoder_layers.launches = 0
    result = model.decode(mel, DecodingOptions(language=None, sample_len=8))
    assert k1.attention.launches > 0 and k2.fused_decoder_layers.launches > 0
    assert all(0 <= t < model.dims.n_vocab for t in result.tokens)
