"""moe.experts_per_step: the routed experts, of the MoE layer's routed
experts (4), that at least one row of a decode step picked, averaged over
the MoE layers of the window's decode steps: what a step must read of the
experts' weights.  From the port's counters (``run.moe``,
``probes/moe_counts.py``: ``experts_hit`` over ``decode_layers``)."""


def read(run):
    moe = getattr(run, "moe", None)
    if not moe or not moe["decode_layers"]:
        return None
    return moe["experts_hit"] / moe["decode_layers"]
