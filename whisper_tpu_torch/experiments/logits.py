"""The logits projection's layouts on the card: the port's
``scripts/_logits_experiment.py``.

    python -m whisper_tpu_torch.experiments.logits [--batch 16] [--inner 50]
        [--outer 3] [--device cuda]

Times x (B, C) . emb^T with large-v3's vocabulary (V = 51866, C = 1280),
bf16, as the script's variants:

  A. torch.mm on the (V, C) embedding, f32 out (the shipped formulation)
  B. torch.mm on a (C, V) copy, f32 out
  C. A with bf16 out
  D. E2 (``ops.kernels.logits``) on the (V, C) embedding
  E. E2 on the (C, V) copy
  F. one f32 sum of the embedding: what its bytes cost as a pure stream

Each is timed over ``--inner`` calls, the best of ``--outer``; each line
gives the embedding's bytes over the time and the bound.  ``--vocab`` and
``--width`` shrink the shape (a run on the CPU).  Returns the rows.
"""

import numpy as np
import torch

from ..ops.kernels.logits import logits_streamed
from ._common import bound, describe, device_of, line, parser, time_ms


def main(argv=None) -> list:
    ap = parser(__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--inner", type=int, default=50)
    ap.add_argument("--outer", type=int, default=3)
    ap.add_argument("--vocab", type=int, default=51866)
    ap.add_argument("--width", type=int, default=1280)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    B, V, C, dt = args.batch, args.vocab, args.width, torch.bfloat16
    rng = np.random.RandomState(0)

    def randn(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.02).astype(np.float32)).to(device, dt)

    x = randn(B, C)
    emb = randn(V, C)
    emb_t = emb.t().contiguous()  # (C, V) copy, made outside the timings
    gb = V * C * 2 / 1e9
    print(f"logits on {describe(device)}: B {B}, V {V}, C {C}, bf16", flush=True)

    def mm(w, out_dtype):
        if device.type == "cuda":
            return lambda: torch.mm(x, w, out_dtype=out_dtype)
        return lambda: torch.matmul(x.float(), w.float()).to(out_dtype)

    variants = [
        ("A torch.mm bc,vc->bv f32 out", mm(emb.t(), torch.float32), 4),
        ("B torch.mm bc,cv->bv (C,V) copy f32 out", mm(emb_t, torch.float32), 4),
        ("C torch.mm bc,vc->bv bf16 out", mm(emb.t(), dt), 2),
        ("D E2 logits_streamed (V,C)", lambda: logits_streamed(x, emb, "vc"), 4),
        ("E E2 logits_streamed (C,V) copy", lambda: logits_streamed(x, emb_t, "cv"), 4),
        ("F raw embedding sum", lambda: emb.sum(dtype=torch.float32), None),
    ]
    rows = []
    for name, fn, out_size in variants:
        ms = time_ms(fn, device, args.inner, args.outer)
        if out_size is None:  # the bytes read once, one add each
            kb = bound(V * C * 2, V * C, "float32")
        else:  # x and the embedding read, the logits written; two operations a product
            kb = bound((B * C + V * C) * 2 + B * V * out_size, 2 * B * V * C, "bfloat16")
        print(line(name, ms, kb, f", {gb / ms * 1e3:7.1f} GB/s"), flush=True)
        rows.append(dict(name=name, ms=ms, **kb))
    return rows


if __name__ == "__main__":
    main()
