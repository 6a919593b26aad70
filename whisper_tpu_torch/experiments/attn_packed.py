"""Two-heads-packed encoder attention on the card: the port's
``scripts/_attn_packed_experiment.py``.

    python -m whisper_tpu_torch.experiments.attn_packed [--reps 64] [--grid 320]
        [--repeats 5] [--device cuda]

Per program (``--grid`` of them, large-v3 at batch 16 has 320 head pairs)
and ``--reps`` dependent iterations: E3 unpacked (``ops.kernels.
attn_packed``), two head-sized score + PV pairs (Q=128, T=1536, D=64), and
E3 packed, one pair (Q=128, 2T=3072, 2D=128) over block-diagonal K/V built
outside the timing (the most favourable case for packing).  Equal useful
work; the packed product also multiplies the zero blocks.  Prints both
times (the best of ``--repeats``), their bounds, the ratio and the
verdict.  ``--q`` and ``--t`` shrink the shape (a run on the CPU).  Returns
the rows.
"""

import math

import numpy as np
import torch

from ..ops.kernels.attn_packed import attn_pairs_packed, attn_pairs_unpacked
from ._common import bound, describe, device_of, line, parser, time_ms


def block_diagonal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(g, T, D) and (g, T, D) -> (g, 2T, 2D): [[a, 0], [0, b]]."""
    zero = torch.zeros_like(a)
    return torch.cat([torch.cat([a, zero], dim=-1), torch.cat([zero, b], dim=-1)], dim=1)


def chain_scale(T: int, D: int = 64, q_scale: float = 0.1, ulps: float = 4.0) -> float:
    """The scale of K and V (unit normal draws times it; q's is q_scale) at
    which each rep's feedback moves qq by about ``ulps`` bf16 ulps of |q|.
    The feedback is bf16(acc) * 1e-9 with acc growing by o * 1e-9 a rep, and
    o = bf16(qq K^T) V is about sqrt(T D) q_scale scale^2.  At the
    experiment's 0.1 the feedback is some 1e-17, far under half an ulp of
    q: every rep's o is then the same, and a kernel that skipped reps would
    pass a numeric check; at this scale the reps form a visible chain."""
    ulp = 2.0 ** (math.floor(math.log2(q_scale)) - 7)
    return math.sqrt(ulps * ulp / 1e-18 / (math.sqrt(T * D) * q_scale))


def main(argv=None) -> list:
    ap = parser(__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=64, help="matmul pairs per program")
    ap.add_argument("--grid", type=int, default=320, help="programs (large-v3 b16 has 320 head-pairs)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--q", type=int, default=128)
    ap.add_argument("--t", type=int, default=1536)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    g, Q, T, D, reps = args.grid, args.q, args.t, 64, args.reps
    rng = np.random.RandomState(0)

    def randn(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.1).astype(np.float32)).to(device, torch.bfloat16)

    q2 = randn(g, Q, 2 * D)
    k1, v1, k2, v2 = (randn(g, T, D) for _ in range(4))
    kp, vp = block_diagonal(k1, k2), block_diagonal(v1, v2)
    print(f"attn packing on {describe(device)}: reps={reps} grid={g} Q={Q} T={T} D={D}", flush=True)
    # useful products per rep: two heads x (score + PV) x 2 Q T D; packed:
    # one (Q, 2T, 2D) pair, 4x one head's, the zero blocks included
    useful = 2 * 2 * 2 * Q * T * D * reps * g
    variants = [
        (f"unpacked 2x({Q},{T},{D}) score+PV pairs", lambda: attn_pairs_unpacked(q2, k1, v1, k2, v2, reps),
         useful, 4 * g * T * D * 2),
        (f"packed   1x({Q},{2 * T},{2 * D}) pair", lambda: attn_pairs_packed(q2, kp, vp, reps),
         2 * useful, 2 * g * 4 * T * D * 2),
    ]
    rows = []
    for name, fn, ops, kv_bytes in variants:  # K/V, then q read and the output written
        ms = time_ms(fn, device, iters=1, repeats=args.repeats)
        kb = bound(kv_bytes + 2 * g * Q * 2 * D * 2, ops, "bfloat16")
        print(line(name, ms, kb, f", {ops / ms / 1e9:.1f} TFLOP/s"), flush=True)
        rows.append(dict(name=name, ms=ms, **kb))
    t_u, t_p = rows[0]["ms"], rows[1]["ms"]
    verdict = "packing could win" if t_p < 0.9 * t_u else "packing cannot win (the packed product pays for its zero blocks)"
    print(f"packed/unpacked: {t_p / t_u:.3f}  ({verdict})", flush=True)
    return rows


if __name__ == "__main__":
    main()
