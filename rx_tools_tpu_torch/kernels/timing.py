"""Device time of a kernel call, measured with CUDA events on the card."""

from __future__ import annotations

import statistics

import torch


def time_ms(fn, args_list, rounds: int = 5, iters: int = 20) -> float:
    """Median per-call device time of ``fn(*args)`` over ``rounds`` rounds
    of ``iters`` calls, inputs rotated through ``args_list``.  Each round
    queues behind a device-side sleep, so the card runs the calls back to
    back and the host's enqueue time is not measured."""
    for a in args_list[:2]:
        fn(*a)                                   # warmup
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)
