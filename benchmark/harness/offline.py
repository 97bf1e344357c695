"""The offline loop (traffic kind "offline"): the configuration's `model`
called on whole clips, `batch` a call, as the public evaluation
(`ts_hear_test.py`) calls the enrollment net on 4 enrollments at a
time: no gradient, float32 with TF32 off, the audio copied to the card
and the d-vectors back to the host each call, in a closed loop.

Set-up draws the weights on the card, builds the model, makes the pool
of seeded binaural scenes on the host (one a length the traffic lists,
`lengths_s`, `batch` of one length to a call) and makes each call of
the pool once. The window makes the pool's calls in turn, in whole
passes, until `seconds` have passed: every run does the same work.
With a trace, `trace_passes` more passes over the pool are traced.
Once the window has closed and the model is freed, the reference's
`forward` computes the outputs of the call of the shortest clips, of
the longest and of one of the others drawn from the seed, and every
output the window produced for them is compared with it."""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark.harness import inputs
from benchmark.harness.trace import capture


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def checked(seed: int, lengths: list) -> list:
    """The pool's calls the check compares, by their clips' `lengths`:
    the shortest, the longest and one of the others drawn from the seed
    (of lengths alike, the first, the last and one between)."""
    order = np.argsort(lengths, kind="stable")
    rng = np.random.default_rng([inputs.seed64(seed), 6])
    return [int(order[0]), int(order[-1]),
            int(order[1 + rng.integers(len(lengths) - 2)])]


def pool_of(cell, seed: int) -> tuple:
    """(the clips' length of each call, each call's clips [batch, mics,
    length]): the traffic's `lengths_s` in turn, `batch` to a call, a
    call's clips of one length."""
    tr, mp = cell.traffic, cell.config["model_params"]
    b = tr["batch"]
    lengths = [int(round(sec * inputs.SAMPLE_RATE))
               for sec in tr["lengths_s"]]
    if len(lengths) % b or any(len(set(lengths[i:i + b])) > 1
                               for i in range(0, len(lengths), b)):
        raise ValueError("lengths_s: whole calls of one length each")
    clips = inputs.enrollments(seed, lengths, mp["num_ch"])
    return lengths[::b], [np.stack(clips[i:i + b])
                          for i in range(0, len(clips), b)]


def expected(cell, params: dict, pool: list, check: list, device,
             mode: str = "f32") -> dict:
    """{call: the reference's outputs [batch, E], float64} of the calls
    `check`, every product in `mode`'s precision."""
    mp, ref = cell.config["model_params"], cell.reference
    return {i: ref.forward(mp, params, torch.from_numpy(pool[i])
                           .to(device), mode).cpu().double().numpy()
            for i in check}


def dvec_err(outputs: list, expect: np.ndarray) -> float:
    """The largest absolute difference between any of `outputs` and the
    reference's `expect` (a non-finite output reads inf)."""
    gap = max(float(np.abs(y.astype(np.float64) - expect).max())
              for y in outputs)
    return float(np.nan_to_num(gap, nan=np.inf))


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_proc: float) -> dict:
    tr, mp, ref = cell.traffic, cell.config["model_params"], cell.reference
    cuda = device.startswith("cuda")
    params = inputs.weights(ref.param_table(mp), seed, device)
    model = cell.named("model")(**mp, device=device)
    model.load_state_dict(params)
    model.eval()
    lengths, pool = pool_of(cell, seed)
    n, rows = len(pool), tr["batch"]
    t_built = time.perf_counter()

    @torch.no_grad()
    def call(x: np.ndarray) -> np.ndarray:
        return model(torch.from_numpy(x).to(device)).cpu().numpy()

    for x in pool:                        # every shape of the window
        call(x)
    setup_s = time.perf_counter() - t_proc
    log(f"set-up {setup_s:.1f} s: {t_built - t_proc:.1f} to the model and "
        f"the pool of {rows * sum(lengths) / inputs.SAMPLE_RATE:.1f} s, "
        f"{setup_s - (t_built - t_proc):.1f} a call on each batch")

    check = checked(seed, lengths)
    produced = {i: [] for i in check}
    samples, failed, k = [], 0, 0
    t_start = time.perf_counter()
    while True:
        i = k % n
        y = call(pool[i])
        k += 1
        samples.append(lengths[i])
        failed += int((~np.isfinite(y)).any(axis=1).sum())
        if i in produced:
            produced[i].append(y)
        if k % n == 0 and time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    audio_s = rows * sum(samples) / inputs.SAMPLE_RATE
    log(f"window {window_s:.2f} s, {k} calls of {rows}, {audio_s:.1f} s "
        f"of audio")

    traced, traced_samples = None, []
    if trace:
        def traced_calls():
            for j in range(tr["trace_passes"] * n):
                with torch.profiler.record_function("bench.call"):
                    call(pool[j % n])
                traced_samples.append(lengths[j % n])
        traced = capture(traced_calls)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    expect = expected(cell, params, pool, check, device)
    gap = max(dvec_err(produced[i], expect[i]) for i in check)
    log(f"reference {time.perf_counter() - t_ref:.1f} s over calls "
        f"{check} of {[lengths[i] / inputs.SAMPLE_RATE for i in check]} s")
    return {
        "setup_s": setup_s,
        "e2e": {"offline_audio_rate": audio_s / window_s},
        "checks": {"dvec_err": gap},
        "attempted": k * rows,
        "failed": failed,
        "memory_peak_bytes": memory_peak,
        "trace": traced,
        "ctx": {"steps": k, "window_s": window_s, "rows_per_step": rows,
                "window_samples": samples, "traced_samples": traced_samples},
    }


def controls(cell, seed: int, mode: str, attempted: int,
             device: str = "cuda") -> dict:
    """{"control": the numbers the comparison reads} of the reference in
    the precision `mode` put in the program's place, against the
    reference, on the calls a run of `seed` checks."""
    mp = cell.config["model_params"]
    params = inputs.weights(cell.reference.param_table(mp), seed, device)
    lengths, pool = pool_of(cell, seed)
    check = checked(seed, lengths)
    expect = expected(cell, params, pool, check, device)
    low = expected(cell, params, pool, check, device, mode)
    return {"control": {"dvec_err": max(dvec_err([low[i]], expect[i])
                                        for i in check)}}
