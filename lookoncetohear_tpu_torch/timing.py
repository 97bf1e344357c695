"""Timing on the card with CUDA events, for the port's measuring scripts
(chip_smoke.py, `python3 -m lookoncetohear_tpu_torch.ab`)."""

from __future__ import annotations

import time

import numpy as np
import torch


def device_ms(fn, reps: int) -> float:
    """Median device time of one call fn(i), i < reps, for a call of a
    few launches. A sleep kernel holds the stream while the host queues
    every call between its pair of CUDA events, so the host's launch
    overhead, larger than many of these calls, is not timed."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    # ~2e9 cycles per second at the H100's clock; 1.5x the host's time
    torch.cuda._sleep(int((1.5 * reps * host_s + 0.01) * 2e9))
    for i in range(reps):
        ev[i][0].record()
        fn(i)
        ev[i][1].record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def wall_ms(fn, reps: int) -> float:
    """Median time from the call of fn(i) to the end of its work on the
    card, for calls of many launches: the host's launch overhead then
    sets the time, and a queue primed as in device_ms would overflow."""
    out = []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))
