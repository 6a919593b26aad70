"""serve.queue_wait_ms: a request's mean wait in BatchingTranscriber's
queue, from ``submit`` to leaving the queue for its batch round, from the
server's own counters over the window (``stats["queue_wait_s"]`` over
``stats["taken"]``)."""


def read(run):
    if not run.stats.get("taken"):
        return None
    return 1e3 * run.stats["queue_wait_s"] / run.stats["taken"]
