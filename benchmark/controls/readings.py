"""The readings the limits of `limits/<workload>.json` are set from, on
the card, at the cell's own size, in one process:

    python3 -m benchmark.controls.readings --workload <name> \
        --seeds 1,2,... --control-seeds 7,8,9 --seconds 10

* program: a whole run of the cell (`run.run_cell`) on each of --seeds:
  the numbers its comparison reads (the lower reading is the largest);
* control: the reference put in the program's place, in the precision
  below the one the cell states (`limits/<workload>.json` "control":
  "tf32" for float32, "fp8" for bfloat16), against the reference, on the
  same inputs and as many frames or steps as a run compares;
* for training cells, the fault of half the batch left out (the mean
  taken over the rest), planted in the reference put in the program's
  place. A step that leaves the state unchanged reads 1 by the change's
  measure and needs no run.

Prints one JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import compare, inputs
from benchmark.harness.cell import load_cell
from benchmark.harness.serve import reference_outputs
from benchmark.reference import train as ref_train
from benchmark.run import run_cell


def serve_control(cell, seed: int, frames: int, mode: str,
                  device: str = "cuda") -> dict:
    tr, mp = cell.traffic, cell.config["model_params"]
    n = tr["streams"]
    params = inputs.weights(mp, seed, device, getattr(torch, tr["dtype"]))
    pool = inputs.serve_pool(seed, n, mp["num_ch"], mp["stft_chunk_size"],
                             tr["pool_chunks"])
    emb = inputs.dvectors(seed, n, mp["embed_dim"])
    rng = np.random.default_rng([inputs.seed64(seed), 3])
    sample = np.sort(rng.choice(n, tr["sample_streams"], replace=False))
    int8 = tr["kv_dtype"] == "int8"
    ref = reference_outputs(mp, params, pool, emb, sample, frames, int8,
                            device)
    low = reference_outputs(mp, params, pool, emb, sample, frames, int8,
                            device, mode=mode)
    return {"out_err": compare.chunk_error(low, ref)}


def train_readings(ref: dict, other: dict) -> dict:
    return {"loss_gap": compare.loss_gap(other["losses"], ref["losses"]),
            "grad_gap": compare.norm_gap(other["grad_norms"],
                                         ref["grad_norms"]),
            "change_gap": compare.norm_gap(other["change_norms"],
                                           ref["change_norms"],
                                           compare.moving(ref["grad_norms"]))}


def train_controls(cell, seed: int, mode: str,
                   device: str = "cuda") -> dict:
    tr, mp, opt = cell.traffic, cell.config["model_params"], \
        cell.config["train"]
    params = inputs.weights(mp, seed, device)
    batches = inputs.train_batches(seed, tr["pool_batches"], tr["batch"],
                                   tr["seconds_audio"], mp["embed_dim"],
                                   device)[:tr["check_steps"]]
    args = (mp, params, batches, opt["lr"], opt["grad_clip"])
    ref = ref_train.steps(*args)
    low = ref_train.steps(*args, mode=mode)
    half = ref_train.steps(*args, rows=slice(0, tr["batch"] // 2))
    return {"control": train_readings(ref, low),
            "fault.half_batch": train_readings(ref, half)}


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    cell = load_cell(Path.cwd() / "BENCHMARK.json", args.workload)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    mode = cell.limits["control"]
    frames = 0
    for seed in map(int, args.seeds.split(",")):
        t0 = time.perf_counter()
        r = run_cell(cell, seed, args.seconds, False, "cuda", t0)
        frames = max(frames, r["attempted"] // cell.traffic.get("streams", 1))
        emit(kind="program", workload=cell.name, seed=seed,
             correct=r["correct"],
             checks={k: v["value"] for k, v in r["checks"].items()},
             metrics={k: v["value"] for k, v in r["metrics"].items()},
             seconds=time.perf_counter() - t0)
    for seed in map(int, args.control_seeds.split(",")):
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "serve":
            emit(kind="control", mode=mode, workload=cell.name, seed=seed,
                 frames=frames, checks=serve_control(cell, seed, frames, mode),
                 seconds=time.perf_counter() - t0)
        else:
            for kind, checks in train_controls(cell, seed, mode).items():
                emit(kind=kind, mode=mode, workload=cell.name, seed=seed,
                     checks=checks, seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
