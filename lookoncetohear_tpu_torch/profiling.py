"""Tracing and latency helpers (counterpart of
`lookoncetohear_tpu/profiling.py`): the program's spans, a
torch.profiler trace, a latency histogram, an operation count, and the
time of a chained step, by CUDA events on the card and by the host's
clock on the CPU."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program's work, recorded only while a
    `torch.profiler` session is active (`trace` below, or any profiler
    an operator or a benchmark starts): then a `record_function` range,
    which the profiler keeps on the clock of its kernel records and to
    which it links the kernels its ops launch (a graph replay's kernels
    link to the replay's `cudaGraphLaunch` instead). At all other times
    one shared no-op context, after a single read of the flag the
    profiler sets. Names start with their layer: `engine.`, `train.`,
    `net.`, `block.`.

        with profiling.span("engine.replay"):
            graph.replay()
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler around a block, written as a Chrome trace to
    logdir/trace.json (chrome://tracing, Perfetto); the CUDA activity is
    recorded where a card is present. Yields the profiler, whose
    `key_averages()` sums the block's ops by name. The program's spans
    (`span`: `engine.*` around the serving step's input, replay and
    fetch, `train.*` around the training step's phases, `net.*` and
    `block.*` around the model's sections) appear in the trace over the
    kernels they launched.

        with profiling.trace("runs/tsh/trace"):
            engine.step(x)
    """
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class LatencyRecorder:
    """Per-chunk latency histogram for streaming serving."""

    def __init__(self) -> None:
        self.samples: list = []

    @contextlib.contextmanager
    def measure(self, sync=None):
        """Time the block by the host's clock. With `sync` (a CUDA
        device) the clock stops after the card has finished the block's
        work; otherwise the block itself must wait for it."""
        t0 = time.perf_counter()
        yield
        if sync is not None and torch.device(sync).type == "cuda":
            torch.cuda.synchronize(sync)
        self.samples.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        a = np.asarray(self.samples)
        if not len(a):
            return {}
        return {
            "n": int(len(a)),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p90_ms": float(np.percentile(a, 90) * 1e3),
            "p99_ms": float(np.percentile(a, 99) * 1e3),
            "max_ms": float(a.max() * 1e3),
        }


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def cost_analysis(fn, *args) -> dict:
    """The operations of one call fn(*args), counted while it runs.

    `flops`: `torch.utils.flop_counter.FlopCounterMode`'s count of the
    call's matrix products, convolutions and attention (2 per
    multiply-add), the counterpart of XLA's figure in the JAX package.
    Work outside those aten ops is not counted: elementwise ops, and
    the port's hand-written kernels, which run through ctypes on the
    card (on the CPU their plain versions' products are counted).
    `bytes_accessed`: the bytes of every tensor among the arguments and
    the result, each counted once, the least any implementation of the
    call must move (XLA's figure sums each op's operands instead)."""
    # imported here: it imports triton where triton is installed, which
    # every module that records spans would otherwise pay for at import
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*_tensors(args), *_tensors(out)))
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": float(nbytes)}


def device_step_time(fn, args, n_iters: int = 40) -> float:
    """Seconds per call of a chained step fn(*args), as the slope
    between runs of n_iters // 4 and n_iters calls, so fixed costs
    cancel. On the card (a CUDA tensor among the arguments) each run
    lies between CUDA events; on the CPU it is timed by the host's
    clock."""
    cuda = any(t.is_cuda for t in _tensors(args))
    fn(*args)

    def run(k):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(k):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(k):
            fn(*args)
        return time.perf_counter() - t0

    w1 = run(n_iters // 4)
    w2 = run(n_iters)
    return (w2 - w1) / (n_iters - n_iters // 4)
