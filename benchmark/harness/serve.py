"""The serving loop (traffic kind "serve"): a closed loop of
`StreamingEngine.step_pipelined` over every attached stream.

Set-up draws the weights on the device, builds the engine, attaches
every stream with its d-vector, primes them (the masked step) and warms
the all-primed graph and the pipeline's buffers. The window then hands
step after step of host chunks to `step_pipelined`, which keeps `depth`
steps in flight, until `seconds` have passed, and drains the pipeline.
With a trace, `trace_steps` more calls are timed on the host alone
(each made once the step it will fetch has finished), then as many
are traced. Every step from the first all-primed one on, warm-up and trace
included, is compared with the reference, for a sample of streams
drawn from the seed, each computed from its first chunk."""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark.harness import compare, inputs
from benchmark.harness.trace import capture


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sampled(seed: int, tr: dict) -> np.ndarray:
    """The streams the check compares, drawn from the seed."""
    rng = np.random.default_rng([inputs.seed64(seed), 3])
    return np.sort(rng.choice(tr["streams"], tr["sample_streams"],
                              replace=False))


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_proc: float) -> dict:
    from lookoncetohear_tpu_torch.serve.engine import StreamingEngine

    tr, mp, ref = cell.traffic, cell.config["model_params"], cell.reference
    d = ref.dims(mp)
    dtype = getattr(torch, tr["dtype"])
    kv_dtype = torch.int8 if tr["kv_dtype"] == "int8" else None
    n, depth = tr["streams"], tr["depth"]
    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    params = inputs.weights(ref.param_table(mp), seed, device, dtype)
    sync()
    t_weights = time.perf_counter()
    net = cell.named("model")(**mp, device=device)
    net.load_state_dict(params)
    eng = StreamingEngine(net, max_streams=n, dtype=dtype,
                          kv_dtype=kv_dtype, device=device,
                          cuda_graph=tr["cuda_graph"])
    del net
    pool = inputs.serve_pool(seed, n, d["M"], d["hop"], tr["pool_chunks"])
    emb = inputs.dvectors(seed, n, d["E"])
    for s in range(n):
        eng.add_stream(s, emb[s])
    n_pool = len(pool)
    t_engine = time.perf_counter()
    eng.step(pool[0])                      # primes every stream
    outputs = []
    k = 1
    for _ in range(tr["warmup_steps"]):
        out = eng.step_pipelined(pool[k % n_pool], depth)
        k += 1
        if out is not None:
            outputs.append(out)
    outputs += eng.drain()
    sync()
    setup_s = time.perf_counter() - t_proc
    log(f"set-up {setup_s:.1f} s: {t_weights - t_proc:.1f} to the weights "
        f"on the card, {t_engine - t_weights:.1f} the engine and streams, "
        f"{setup_s - (t_engine - t_proc):.1f} priming and warm-up")

    # the window
    starts, done = [], []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out = eng.step_pipelined(pool[k % n_pool], depth)
        t1 = time.perf_counter()
        k += 1
        starts.append(t0)
        if out is not None:
            outputs.append(out)
            done.append(t1)
        if t1 - t_start >= seconds:
            break
    rest = eng.drain()
    t_end = time.perf_counter()
    outputs += rest
    done += [t_end] * len(rest)
    window_s = t_end - t_start
    steps = len(starts)
    latency_ms = (np.asarray(done) - np.asarray(starts)) * 1e3
    log(f"window {window_s:.2f} s, {steps} steps")

    traced, host_spans = None, []
    if trace:
        # the host's own work a call: each call is made once the step it
        # will fetch has finished (an event recorded after the call that
        # enqueued it), so the wait inside the call returns at once
        marks = []
        for _ in range(tr["trace_steps"]):
            if len(marks) == depth:
                marks.pop(0).synchronize()
            t0 = time.perf_counter()
            out = eng.step_pipelined(pool[k % n_pool], depth)
            t1 = time.perf_counter()
            k += 1
            if cuda:
                marks.append(torch.cuda.Event())
                marks[-1].record()
            if out is not None:
                outputs.append(out)
                host_spans.append(t1 - t0)

        def traced_steps():
            nonlocal k
            for _ in range(tr["trace_steps"]):
                with torch.profiler.record_function("bench.step_pipelined"):
                    out = eng.step_pipelined(pool[k % n_pool], depth)
                k += 1
                if out is not None:
                    outputs.append(out)
            with torch.profiler.record_function("bench.drain"):
                outputs.extend(eng.drain())
            sync()
        traced = capture(traced_steps)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    # the reference, for a sample of streams, from their first chunk
    y = np.stack(outputs, axis=1)              # [streams, frames, S, hop]
    frames = y.shape[1]
    sample = sampled(seed, tr)
    expect = ref.serve_outputs(mp, params, pool, emb, sample, frames,
                               tr["kv_dtype"] == "int8", device)
    gap = compare.chunk_error(y[sample], expect)
    log(f"reference {time.perf_counter() - t_ref:.1f} s over {frames} frames"
        f" of streams {sample.tolist()}")
    return {
        "setup_s": setup_s,
        "e2e": {"rt_streams": n * d["hop"] / inputs.SAMPLE_RATE * steps
                / window_s,
                "chunk_p95_ms": float(np.percentile(latency_ms, 95))},
        "checks": {"out_err": gap},
        "attempted": frames * n,
        "failed": int((~np.isfinite(y).all(axis=(2, 3))).sum()),
        "memory_peak_bytes": memory_peak,
        "trace": traced,
        "ctx": {"steps": steps, "window_s": window_s,
                "host_spans_s": host_spans, "rows_per_step": n},
    }


def controls(cell, seed: int, mode: str, attempted: int,
             device: str = "cuda") -> dict:
    """{"control": the numbers the comparison reads} of the reference in
    the precision `mode` put in the program's place, against the
    reference, on the inputs of `seed` and the frames of a run that
    compared `attempted` outputs (frames x streams)."""
    tr, mp, ref = cell.traffic, cell.config["model_params"], cell.reference
    d = ref.dims(mp)
    n = tr["streams"]
    frames = attempted // n
    params = inputs.weights(ref.param_table(mp), seed, device,
                            getattr(torch, tr["dtype"]))
    pool = inputs.serve_pool(seed, n, d["M"], d["hop"], tr["pool_chunks"])
    emb = inputs.dvectors(seed, n, d["E"])
    sample = sampled(seed, tr)
    int8 = tr["kv_dtype"] == "int8"
    expect = ref.serve_outputs(mp, params, pool, emb, sample, frames, int8,
                               device)
    low = ref.serve_outputs(mp, params, pool, emb, sample, frames, int8,
                            device, mode=mode)
    return {"control": {"out_err": compare.chunk_error(low, expect)}}
