"""The MoE layers' program counters over a traced window, as ``run.moe``:
the model's ``moe_counts`` (``whisper_tpu_torch.models.uni_moe.MoeCounts``:
token-layers routed, picks per expert with the null experts last, decode
steps times layers, and over those the tokens routed and the routed experts
that at least one of a step's rows picked) read at the window's start and at its end, and their
difference kept.  The counters are added to on the card without a host
sync; they are read here, outside the window's work.  A model without MoE
layers has no counters, and the probe does nothing."""

import contextlib


def _delta(after: dict, before: dict) -> dict:
    out = dict(after)
    for k in ("token_layers", "decode_layers", "decode_token_layers", "experts_hit"):
        out[k] = after[k] - before[k]
    out["picks"] = [a - b for a, b in zip(after["picks"], before["picks"])]
    return out


@contextlib.contextmanager
def install(run):
    counts = getattr(getattr(run, "model", None), "moe_counts", None)
    if counts is None:
        yield
        return
    before = counts.read()
    try:
        yield
    finally:
        run.moe = _delta(counts.read(), before)
