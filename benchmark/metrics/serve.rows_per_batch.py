"""serve.rows_per_batch: requests per batch round of BatchingTranscriber
over the window, from its own counters (``stats["requests"]`` over
``stats["batches"]``)."""


def read(run):
    if not run.stats.get("batches"):
        return None
    return run.stats["requests"] / run.stats["batches"]
