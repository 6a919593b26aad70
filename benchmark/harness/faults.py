"""Faults planted in the timed path underneath a run, each of which the
comparison with the reference has to see: ``tests/test_portbench_reference.py``
plants them on the CPU at a tiny width, ``calibrate.py --fault-seeds`` on
the card at a cell's own size.  Each is a context manager that patches
the port while it is open."""

import contextlib
import functools


@contextlib.contextmanager
def _patched(owner, name: str, make):
    """``owner.name`` replaced by ``make(original)`` while open."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def token_altered():
    """A token changed where the engine commits it (row 0, step 5)."""
    from whisper_tpu_torch import engine

    def make(update):
        def altered(spec, state, *a, **kw):
            out = update(spec, state, *a, **kw)
            if state.step == 5:
                col = (out.t[0] - 1).clamp(min=0)
                out.tokens[0, col] = out.tokens[0, col] + 1
            return out

        return altered

    return _patched(engine, "_greedy_update", make)


def half_the_batch():
    """Half of a round's windows decoded; the other half answered with the
    decoded half's results."""
    from whisper_tpu_torch.decoding import DecodingTask

    def make(run):
        def half(self, mel, prompts, *a, **kw):
            n = max(1, len(prompts) // 2)
            out = run(self, mel[:n], prompts[:n], *a, **kw)
            return [out[i % n] for i in range(len(prompts))]

        return half

    return _patched(DecodingTask, "run_with_prompts", make)


def state_unchanged():
    """The decoder step's layers (K2 on the card, its plain version on the
    CPU) leave the hidden state as it came."""
    from whisper_tpu_torch.ops.kernels import fused_step

    def make(layers):
        @functools.wraps(layers)  # keeps its launch counters
        def unchanged(blocks, n_head, x, *a, **kw):
            _, k_new, v_new = layers(blocks, n_head, x, *a, **kw)
            return x.clone(), k_new, v_new

        return unchanged

    return _patched(fused_step, "fused_decoder_layers", make)


FAULTS = {f.__name__: f for f in (token_altered, half_the_batch, state_unchanged)}
