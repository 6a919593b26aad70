"""moe.routed_per_token: routed (not null) picks a token and MoE layer,
from 0 to the router's cap (2), over every token the window routed,
prefill and decode: what sets the routed experts' compute.  From the port's
counters (``run.moe``, ``probes/moe_counts.py``: the routed experts'
``picks`` over ``token_layers``)."""


def read(run):
    moe = getattr(run, "moe", None)
    if not moe or not moe["token_layers"]:
        return None
    return sum(moe["picks"][: moe["n_routed"]]) / moe["token_layers"]
