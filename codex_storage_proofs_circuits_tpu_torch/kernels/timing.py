"""Time on the card of the kernels a call launches (device_ms) and of a
path end to end (events_ms), by CUDA events.

CUDA events around a loop of launches measure the span from the first to
the last, which for a kernel of some ten microseconds is the pace at which
the host can launch it, not the kernel.  device_ms therefore has a spin
kernel hold the stream while the host queues the calls, so that the card
runs them back to back.  (torch.profiler's device events would give each
kernel's duration, but several profiler sessions in one process lose
events with the torch of the GPU machine.)  Needs a CUDA device; imports
only torch, so a script may load it by path beside another checkout's
package.
"""

from __future__ import annotations

import torch

HOLD_CYCLES = (10**7, 10**8, 10**9)  # about 5 ms, 50 ms, 0.5 s at 2 GHz


def events_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean time in ms of one fn() call, by CUDA events around reps calls
    after one warm-up call (none with warmup=False, for a call that takes
    seconds): the card's time end to end, host gaps included (for paths of
    many small kernels, or that copy from host memory)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time in ms of one fn() call, over reps calls queued
    behind a spin kernel after one warm-up call.  If the host has not queued
    them all before the spin ends, a longer spin is tried; a call that waits
    for the card (a copy from pageable host memory) can never be queued
    behind it, and raises."""
    fn()
    torch.cuda.synchronize()
    for cycles in HOLD_CYCLES:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()  # the card had not reached `start` when the last call was queued
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
    raise RuntimeError("the host could not queue the calls while the card was held;"
                       " time a call that waits for the card with events_ms")
