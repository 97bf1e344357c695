"""Timing on the card with CUDA events, and the ring attention step's
inputs and raw C entries, for the port's measuring scripts
(chip_smoke.py, `python3 -m lookoncetohear_tpu_torch.ab`, `.attn_phases`,
`.attn_sweep`)."""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from lookoncetohear_tpu_torch import _build


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


def attn_inputs(gen, rows: int, w1: int, dk: int, dv: int, qdt, kvdt):
    """q, k_t, v_t, k_buf, v_buf, k_scale, v_scale of one ring attention
    step (the scales None for a float ring), made on the card from the
    generator `gen`: int8 rings in [-127, 127] with scales in
    [1e-3, 2e-2), everything else standard normal."""
    dev = gen.device
    a = [torch.randn(s, generator=gen, device=dev).to(qdt)
         for s in ((rows, dk), (rows, dk), (rows, dv))]
    if kvdt == torch.int8:
        a += [torch.randint(-127, 128, (rows, w1, d), generator=gen,
                            device=dev, dtype=torch.int8) for d in (dk, dv)]
        return a + [torch.rand((rows, w1), generator=gen, device=dev)
                    * 1.9e-2 + 1e-3 for _ in range(2)]
    return a + [torch.randn((rows, w1, d), generator=gen, device=dev)
                .to(kvdt) for d in (dk, dv)] + [None, None]


def attn_entry(lib, name: str):
    """fn(args, out): the C entry `name` of a library built from a version
    of csrc/attn_step.cu, launched on the current stream with the seven
    tensors of `attn_inputs` and the output."""
    entry = getattr(lib, name)
    entry.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]

    def fn(args, out):
        q, _, _, kb, _, _, _ = args
        rows, w1, dk = kb.shape
        _build.check(entry(
            *[t.data_ptr() if t is not None else None for t in args],
            out.data_ptr(), rows, w1, dk, out.shape[-1],
            float(1.0 / np.sqrt(dk)),
            torch.cuda.current_stream().cuda_stream), name)
        return out
    return fn
