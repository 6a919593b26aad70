"""engine.step_host_ms: the host's time per token step, the mean length of
the port's ``whisper.step`` ranges inside the traced window (the engine's
``step`` span: a step's logit filters, token update, the decode step's
call and the logits, up to the loop's read of its stop flag, which is the
``sync`` span outside it).  It includes the cost of recording the step's
spans (``probes/spans.py``)."""

SPAN = "whisper.step"


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    steps = [b - a for name, a, b, _ in t.host if name == SPAN and a >= t.start and b <= t.end]
    if not steps:
        return None
    return 1e3 * sum(steps) / len(steps)
