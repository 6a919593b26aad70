"""Each K2 step's rows, audios, cache length and positions, recorded around
the engine's two kernel step functions (``engine.decoder_step_fused`` and
``engine.decoder_step_fused_pending``) as ``run.k2``; ``k2.roofline_pct``
counts the bytes of these launches.  Beside them, as ``run.layouts``, the
window's K2 launches by layout, from the port's counter
``fused_decoder_layers.launches_by_layout`` (``batch.rows_per_step``).

Nothing is read back from the card while the window runs: a position
tensor is kept as it is and read once the window has closed.
"""

import collections
import contextlib
from typing import List

import torch


class K2Steps:
    """The decode steps that went through K2 while installed."""

    def __init__(self):
        self.records: List[tuple] = []  # (rows, audios, T, positions, pending columns)

    def record(self, tokens, t, w, cache):
        xk = cache.cross_k if isinstance(cache.cross_k, torch.Tensor) else cache.cross_k[0]
        self.records.append((int(tokens.shape[0]), int(xk.shape[1]), int(cache.self_k.shape[-1]), t, w))

    def launches(self) -> List[tuple]:
        """(rows, audios, T, per-row positions, pending columns) of each
        step, the positions read from the card now."""
        host = {}
        out = []
        for rows, audios, T, t, w in self.records:
            if isinstance(t, torch.Tensor):
                if id(t) not in host:
                    host[id(t)] = (t, t.tolist())
                positions = host[id(t)][1]
            else:
                positions = [int(t)] * rows
            out.append((rows, audios, T, positions, w))
        return out


def _layouts() -> collections.Counter:
    from whisper_tpu_torch.ops.kernels import fused_step

    return collections.Counter(fused_step.fused_decoder_layers.launches_by_layout)


@contextlib.contextmanager
def install(run):
    from whisper_tpu_torch import engine

    run.k2 = steps = K2Steps()
    layouts0 = _layouts()
    step, pending = engine.decoder_step_fused, engine.decoder_step_fused_pending

    def step_probe(params, dims, tokens, t, cache):
        steps.record(tokens, t, 0, cache)
        return step(params, dims, tokens, t, cache)

    def pending_probe(params, dims, tokens, t, block_start, w, pend_k, pend_v, cache):
        steps.record(tokens, block_start, w, cache)
        return pending(params, dims, tokens, t, block_start, w, pend_k, pend_v, cache)

    engine.decoder_step_fused, engine.decoder_step_fused_pending = step_probe, pending_probe
    try:
        yield
    finally:
        engine.decoder_step_fused, engine.decoder_step_fused_pending = step, pending
        run.layouts = _layouts() - layouts0
