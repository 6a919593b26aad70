"""closed_batch: bulk transcription.  ``transcribe_batch`` calls back to
back, each with the mix's ``files_per_call`` files (``traffic.batch_calls``);
the window closes at the end of the first call that ends after the
window's seconds.  End to end: ``audio_s_per_s``, the audio of the calls
over the wall from the first call's start to the last call's end."""

import time

from benchmark.harness import traffic


def setup(run, warm: bool) -> None:
    """With ``warm``, one call of the mix's own sizes (set-up)."""
    if warm:
        from whisper_tpu_torch import transcribe_batch

        files = traffic.batch_calls(run.seed, run.cell.mix, run.wave, 1, first=10**6)[0]
        transcribe_batch(run.model, files, batch_size=run.cell.mix["batch_size"], **run.options())


def window(run) -> None:
    from whisper_tpu_torch import transcribe_batch

    mix = run.cell.mix
    run.files, run.results = [], []
    start = None
    c = 0
    while True:
        files = traffic.batch_calls(run.seed, mix, run.wave, 1, first=c)[0]
        now = time.perf_counter()
        start = now if start is None else start
        run.results += transcribe_batch(run.model, files, batch_size=mix["batch_size"], **run.options())
        run.files += files
        c += 1
        end = time.perf_counter()
        if end - start >= run.seconds:
            break
    run.wall_s = end - start
    run.failed = 0


def values(run) -> dict:
    audio = sum(len(f) for f in run.files) / traffic.SAMPLE_RATE
    return {"audio_s_per_s": audio / run.wall_s}


def close(run) -> None:
    pass
