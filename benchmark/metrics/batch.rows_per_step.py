"""batch.rows_per_step: rows a K2 step decodes, averaged over the window's
K2 launches, from the port's counter ``fused_decoder_layers.launches_by_layout``
over the window (``run.layouts``, ``probes/k2_steps.py``; a key (A, G[, tag])
is A audios of G rows each)."""


def read(run):
    launches = sum(run.layouts.values())
    if not launches:
        return None
    return sum(key[0] * key[1] * n for key, n in run.layouts.items()) / launches
