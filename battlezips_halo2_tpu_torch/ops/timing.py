"""Timing of launches on the card, shared by chip_smoke.py and the tools.

:func:`device_paced_ms` lets the card set the pace: the host queues every
timed launch behind a wait on the card before the first one runs, so a
kernel shorter than the host's launch rate still reads its own time.
:func:`host_paced_ms` is CUDA events around a Python loop of calls: where a
call takes the host longer than the card, it reads the host's launch rate.
"""

from __future__ import annotations

import time

import torch

# torch.cuda._sleep counts SM clock cycles; 2e9 a second is above the
# H100's 1980 MHz maximum, so a wait lasts at least as long as asked
SLEEP_CYCLES_PER_S = 2.0e9


def host_paced_ms(fn, reps: int) -> float:
    """Mean time of fn() over reps calls by CUDA events around a Python loop
    of calls, warmed up. Where a call takes the host longer than the card,
    this is the host's launch rate, not the kernel's time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_paced_ms(fn, reps: int, setup=None) -> float:
    """Mean device time of fn() over reps calls, with the card setting the
    pace: a wait on the card (``torch.cuda._sleep``), twice as long as the
    host took to queue the reps calls, runs before the start event, so
    every timed launch is queued before the first one runs. The start
    event must still be pending once the last call is queued; else the
    wait grows fourfold and the window runs again. ``setup()`` (for example
    restoring inputs that fn updates in place) runs before each window,
    outside it. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_paced_ms times the card: no CUDA device")
    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    if setup:
        setup()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    wait_s = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    for _ in range(4):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(wait_s * SLEEP_CYCLES_PER_S))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        wait_s *= 4
    raise RuntimeError("the host did not queue the timed launches ahead of the card")
