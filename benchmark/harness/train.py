"""The training loop (traffic kind "train"): `Trainer.train_step` of the
configuration's `task` (with its `model`) over a pool of seeded batches
on the device.

Set-up builds the task and the trainer (Adam, the configuration's clip),
loads the weights drawn from the seed, and drives that one trainer
through its first `check_steps` steps on the pool's first batches (rows
that all differ), keeping what the check compares: each step's loss,
the first gradient as Adam holds it (its first moment over 1 - beta1)
and the parameters after the last of them. The window then steps the
same trainer on the pool in turn, `in_flight` steps queued at most,
until `seconds` have passed. Once the window has closed and the trainer
is freed, the configuration's `train_reference` (its `steps`) takes the
same steps from the same weights."""

from __future__ import annotations

import gc
import math
import sys
import tempfile
import time

import torch

from benchmark.harness import compare, inputs
from benchmark.harness.trace import capture


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_proc: float) -> dict:
    from lookoncetohear_tpu_torch.train.trainer import ADAM_BETAS, Trainer

    tr, mp, opt = cell.traffic, cell.config["model_params"], \
        cell.config["train"]
    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    marks = [("imports", time.perf_counter())]
    task = cell.named("task")(model=cell.config["model"],
                              model_params=dict(mp, remat=opt["remat"]),
                              lr=opt["lr"])
    marks.append(("task", time.perf_counter()))
    run_dir = tempfile.TemporaryDirectory()
    trainer = Trainer(task, run_dir.name, grad_clip=opt["grad_clip"],
                      device=device)
    sync()
    marks.append(("trainer", time.perf_counter()))
    params = inputs.weights(cell.reference.param_table(mp), seed, device)
    trainer.model.load_state_dict(params)
    batches = inputs.train_batches(seed, tr["pool_batches"], tr["batch"],
                                   tr["seconds_audio"], mp["embed_dim"],
                                   device)
    sync()
    t_built = time.perf_counter()
    marks.append(("weights and batches", t_built))
    named = dict(trainer.model.named_parameters())
    n_check = tr["check_steps"]
    losses = []
    for k in range(n_check):
        losses.append(trainer.train_step(batches[k], 0)["loss"])
        if k == 0:
            # a parameter Adam left without state has moved nothing
            grads = {n: float(trainer.opt.state[p]["exp_avg"].norm())
                     / (1 - ADAM_BETAS[0]) if "exp_avg" in
                     trainer.opt.state[p] else 0.0
                     for n, p in named.items()}
    change = {n: float((p.detach() - params[n]).norm())
              for n, p in named.items()}
    losses = [float(v) for v in losses]
    sync()
    setup_s = time.perf_counter() - t_proc
    log(f"set-up {setup_s:.1f} s: " + ", ".join(
        f"{name} {t - t0:.1f}" for (name, t), (_, t0) in
        zip(marks, [("start", t_proc)] + marks[:-1]))
        + f", the first {n_check} steps {setup_s - (t_built - t_proc):.1f}")

    peak_before = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    queued, window_losses = [], []
    k = n_check
    t_start = time.perf_counter()
    while True:
        window_losses.append(trainer.train_step(
            batches[k % len(batches)], 0)["loss"])
        k += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            queued.append(ev)
            if len(queued) > tr["in_flight"]:
                queued.pop(0).synchronize()
        if time.perf_counter() - t_start >= seconds:
            break
    sync()
    t_end = time.perf_counter()
    window_s = t_end - t_start
    steps = k - n_check
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window {window_s:.2f} s, {steps} steps")

    traced = None
    if trace:
        def traced_steps():
            nonlocal k
            for _ in range(tr["trace_steps"]):
                with torch.profiler.record_function("bench.train_step"):
                    trainer.train_step(batches[k % len(batches)], 0)
                k += 1
            sync()
        traced = capture(traced_steps)
    memory_peak = max(peak_before, torch.cuda.max_memory_allocated()
                      if cuda else 0)
    failed = int(sum(not math.isfinite(float(v)) for v in window_losses))
    del trainer, task, named, window_losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    run_dir.cleanup()

    t_ref = time.perf_counter()
    expect = cell.module("train_reference").steps(
        mp, params, batches[:n_check], opt["lr"], opt["grad_clip"])
    log(f"reference {time.perf_counter() - t_ref:.1f} s, {n_check} steps")
    audio_s = tr["batch"] * tr["seconds_audio"]
    return {
        "setup_s": setup_s,
        "e2e": {"train_audio_rate": audio_s * steps / window_s},
        "checks": readings(expect, {"losses": losses, "grad_norms": grads,
                                    "change_norms": change}),
        "attempted": steps,
        "failed": failed,
        "memory_peak_bytes": memory_peak,
        "trace": traced,
        "ctx": {"steps": steps, "window_s": window_s,
                "window_peak_bytes": window_peak,
                "rows_per_step": tr["batch"]},
    }


def readings(expect: dict, other: dict) -> dict:
    """The numbers the comparison reads, of `other` against the
    reference's `expect` (each {"losses", "grad_norms",
    "change_norms"})."""
    return {"loss_gap": compare.loss_gap(other["losses"], expect["losses"]),
            "grad_gap": compare.norm_gap(other["grad_norms"],
                                         expect["grad_norms"]),
            "change_gap": compare.norm_gap(
                other["change_norms"], expect["change_norms"],
                compare.moving(expect["grad_norms"]))}


def controls(cell, seed: int, mode: str, attempted: int,
             device: str = "cuda") -> dict:
    """The readings of the reference put in the program's place, on the
    inputs of `seed`: in the precision `mode` ("control") and with half
    of the batch left out, the mean taken over the rest
    ("fault.half_batch"). A step that leaves the state unchanged reads 1
    by the change's measure and needs no run."""
    tr, mp, opt = cell.traffic, cell.config["model_params"], \
        cell.config["train"]
    steps = cell.module("train_reference").steps
    params = inputs.weights(cell.reference.param_table(mp), seed, device)
    batches = inputs.train_batches(seed, tr["pool_batches"], tr["batch"],
                                   tr["seconds_audio"], mp["embed_dim"],
                                   device)[:tr["check_steps"]]
    args = (mp, params, batches, opt["lr"], opt["grad_clip"])
    expect = steps(*args)
    low = steps(*args, mode=mode)
    half = steps(*args, rows=slice(0, tr["batch"] // 2))
    return {"control": readings(expect, low),
            "fault.half_batch": readings(expect, half)}
