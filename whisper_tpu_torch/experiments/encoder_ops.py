"""The encoder's hot ops on the card: the port's ``scripts/bench_encoder_ops.py``.

    python -m whisper_tpu_torch.experiments.encoder_ops [--batch 16] [--heads 20]
        [--t 1500] [--d 64] [--c 1280] [--device cuda]

Times, in bf16 at large-v3's encoder shapes (batch 16 by default):

- K1 (``ops.kernels.attention``) at head dim ``--d`` (64 or 128), beside
  ``scaled_dot_product_attention`` as the yardstick (never called by the
  port);
- the MLP's fc2 with its residual, (B T, 4C) x (4C, C): the encoder's
  torch-route fc2 (``_linear`` then the residual add: the library GEMM and
  two adds; the kernel route runs ``ops.kernels.encoder_block``),
  the f32-output product rounded once then the bias and residual, and E1
  (``ops.kernels.matmul_residual``, the fused epilogue);
- fc1 + GELU, for reference.

Each line gives the bound (bytes at 3.35 TB/s or operations at 989
TFLOP/s, whichever takes longer).  Returns the rows.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..models.whisper import _gelu, _linear
from ..ops.kernels.attention import attention
from ..ops.kernels.matmul_residual import matmul_residual
from ._common import bound, describe, device_of, line, parser, time_ms


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result: one library call on the card."""
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return torch.matmul(x.float(), w.float())


def main(argv=None) -> list:
    ap = parser(__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--heads", type=int, default=20)
    ap.add_argument("--t", type=int, default=1500)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--c", type=int, default=1280)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    dt = torch.bfloat16
    b, h, t, d, c = args.batch, args.heads, args.t, args.d, args.c
    rng = np.random.RandomState(0)

    def randn(*shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device, dt)

    print(f"encoder ops on {describe(device)}: batch {b}, heads {h}, T {t}, D {d}, C {c}, bf16",
          flush=True)
    rows = []

    def record(name, fn, n_bytes, n_ops):
        ms = time_ms(fn, device)
        kb = bound(n_bytes, n_ops, "bfloat16")
        print(line(name, ms, kb, f", {n_ops / ms / 1e9:.1f} TFLOP/s"), flush=True)
        rows.append(dict(name=name, ms=ms, **kb))
        return ms

    q, k, v = (randn(b, h, t, d, scale=0.3) for _ in range(3))
    flops = 4 * b * h * t * t * d
    k1 = record(f"K1 encoder attention, D={d}", lambda: attention(q, k, v), 4 * q.numel() * 2, flops)
    sdpa = record("yardstick: scaled_dot_product_attention", lambda: F.scaled_dot_product_attention(q, k, v),
                  4 * q.numel() * 2, flops)
    print(f"K1 / SDPA: {k1 / sdpa:.3f}", flush=True)
    del q, k, v

    # fc2 + residual: x (B T, 4C) against the port's (C, 4C) weight, and E1's
    # (4C, C) layout of the same weight (the script's)
    m = b * t
    x = randn(m, 4 * c, scale=0.3)
    res = randn(m, c, scale=0.3)
    w = randn(c, 4 * c, scale=0.02)
    w_kn = w.t().contiguous()
    bias = torch.zeros(c, dtype=dt, device=device)
    fc2_bytes = (m * 4 * c + 4 * c * c + c + 2 * m * c) * 2
    fc2_flops = 2 * m * 4 * c * c
    linear = record("fc2 the port's: _linear + residual", lambda: res + _linear(x, w, bias),
                    fc2_bytes, fc2_flops)
    record("fc2 f32 product, rounded once, + bias + res",
           lambda: res + (_f32_product(x, w_kn).to(dt) + bias), fc2_bytes, fc2_flops)
    e1 = record("fc2 E1 matmul_residual (fused epilogue)", lambda: matmul_residual(x, w_kn, bias, res),
                fc2_bytes, fc2_flops)
    print(f"E1 / the port's fc2: {e1 / linear:.3f}", flush=True)
    del x, res, w, w_kn

    x1 = randn(m, c, scale=0.3)
    w1 = randn(4 * c, c, scale=0.02)
    record("fc1 + GELU (reference)", lambda: _gelu(_linear(x1, w1)), (m * c + 4 * c * c + 4 * m * c) * 2,
           fc2_flops)
    return rows


if __name__ == "__main__":
    main()
