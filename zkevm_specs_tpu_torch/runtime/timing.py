"""The device time of one call, from CUDA events around it.

``chip_smoke.py`` imports ``time_on_card_ms``; ``profile_replay.py`` puts
this file's source before each child script it runs, so a checkout given
to it that predates the module is timed the same way.
"""
import statistics

import torch

SLEEP_CYCLES = 200_000
MAX_SLEEP_CYCLES = SLEEP_CYCLES << 6   # about 7 ms


def time_on_card_ms(fn, repeats=10, warmup=3):
    """Median device time of one call of ``fn``, over ``repeats`` after
    ``warmup`` calls.  A sleep kernel is queued first so the start event
    fires after the host has enqueued the call, and the interval is the
    device's work alone: where the start event has already fired when the
    host returns from the call, the host's enqueue time would be in the
    interval, and the repetition is made again with a sleep twice as long
    (up to MAX_SLEEP_CYCLES; a call that takes longer to enqueue keeps its
    launch gaps)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    sleep = SLEEP_CYCLES
    while len(times) < repeats:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        fn()
        host_behind = start.query()
        end.record()
        end.synchronize()
        if host_behind and sleep < MAX_SLEEP_CYCLES:
            sleep *= 2
            continue
        times.append(start.elapsed_time(end))
    return statistics.median(times)
