"""The readings the limits of `limits/<workload>.json` are set from, on
the card, at the cell's own size, in one process:

    python3 -m benchmark.controls.readings --workload <name> \
        --seeds 1,2,... --control-seeds 7,8,9 --seconds 10

* program: a whole run of the cell (`run.run_cell`) on each of --seeds:
  the numbers its comparison reads (the lower reading is the largest);
* control: what the loop of the cell's kind reads (`controls` of
  `harness/<kind>.py`): the reference put in the program's place, in the
  precision below the one the cell states (`limits/<workload>.json`
  "control": "tf32" for float32, "fp8" for bfloat16), against the
  reference, on the same inputs and as many frames, steps or utterances
  as a run compares; for training cells also the fault of half the
  batch left out (the mean taken over the rest), planted in the
  reference put in the program's place.

Prints one JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from benchmark.harness.cell import load_cell
from benchmark.run import run_cell


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
    attempted = 0
    for seed in map(int, args.seeds.split(",")):
        t0 = time.perf_counter()
        r = run_cell(cell, seed, args.seconds, False, "cuda", t0)
        attempted = max(attempted, r["attempted"])
        emit(kind="program", workload=cell.name, seed=seed,
             correct=r["correct"],
             checks={k: v["value"] for k, v in r["checks"].items()},
             metrics={k: v["value"] for k, v in r["metrics"].items()},
             seconds=time.perf_counter() - t0)
    for seed in map(int, args.control_seeds.split(",")):
        t0 = time.perf_counter()
        out = cell.loop.controls(cell, seed, mode, attempted)
        for kind, checks in out.items():
            emit(kind=kind, mode=mode, workload=cell.name, seed=seed,
                 attempted=attempted, checks=checks,
                 seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
