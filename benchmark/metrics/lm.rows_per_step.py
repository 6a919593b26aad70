"""lm.rows_per_step: rows a decode step of the language model carries,
averaged over the window's decode steps: what a step's read of the
experts' weights is shared by.  From the port's MoE counters (``run.moe``,
``probes/moe_counts.py``: ``decode_token_layers`` over ``decode_layers``,
each a step's rows or a step times the model's layers)."""


def read(run):
    moe = getattr(run, "moe", None)
    if not moe or not moe["decode_layers"]:
        return None
    return moe["decode_token_layers"] / moe["decode_layers"]
