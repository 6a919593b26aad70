"""encoder.ms_per_window: the card's time in the port's ``encoder`` span
(CUDA events of ``run.timer``, ``probes/spans.py``: from the device
reaching the span's start to its end, the encoder's queued kernels and any
wait for their launches) over the windows that the server's rounds encoded
(``run.rounds``, ``probes/rounds.py``)."""


def read(run):
    timer, rounds = getattr(run, "timer", None), getattr(run, "rounds", None)
    if timer is None or rounds is None or not sum(rounds.audios):
        return None
    seconds = timer.totals.get("encoder", 0.0)
    if seconds <= 0:
        return None
    return 1e3 * seconds / sum(rounds.audios)
