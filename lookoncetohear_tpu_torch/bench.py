"""Streaming benchmark of the port: real-time factor of the flagship
separator's serving step on one NVIDIA GPU.

    python3 -m lookoncetohear_tpu_torch.bench

64 streams of the flagship (`entry.FLAGSHIP`, weights
checkpoints/tsh_r5_5k_best.npz) in the serving precision, bf16 with the
int8 K/V ring, through `StreamingEngine.benchmark_device`: CUDA-graph
replays of the all-primed step between CUDA events at two run lengths,
per-step time = the slope. Earlier lines name the card and its power
limit (nvidia-smi) and carry the benchmark's whole report; the last
line is one JSON object

  {"metric": "streaming_rtf_64", "value": <device ms per step / 8 ms>,
   "unit": "xRT", "vs_baseline": <0.1 / value>}

vs_baseline > 1 means the north-star target (RTF < 0.1 at 64
concurrent streams, BASELINE.md) is beaten by that factor. Exits
non-zero, with no result line, on any failure, without a card, or
after LIMIT_S seconds.
"""

from __future__ import annotations

import faulthandler
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from lookoncetohear_tpu_torch.entry import FLAGSHIP
from lookoncetohear_tpu_torch.models.net import Net
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
from lookoncetohear_tpu_torch.weights import load_npz, params_from_jax

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / \
    "tsh_r5_5k_best.npz"
STREAMS = 64
STEPS_SHORT, STEPS_LONG, REPEATS = 100, 500, 4
TARGET_RTF = 0.1
LIMIT_S = 600


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(LIMIT_S, exit=True)
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card()}",
          flush=True)
    net = Net(**FLAGSHIP, device="cpu")
    eng = StreamingEngine(net, params_from_jax(load_npz(str(CKPT))),
                          max_streams=STREAMS, dtype=torch.bfloat16,
                          kv_dtype=torch.int8)
    emb = np.random.default_rng(0).standard_normal(
        (STREAMS, FLAGSHIP["embed_dim"])).astype(np.float32)
    for s in range(STREAMS):
        eng.add_stream(s, emb[s] / np.linalg.norm(emb[s]))
    rep = eng.benchmark_device(STEPS_SHORT, STEPS_LONG, REPEATS)
    print(f"benchmark_device, {STREAMS} streams, bf16 + int8 K/V, CUDA "
          f"graph: {json.dumps(rep)}", flush=True)
    rtf = rep["rtf"]
    if not np.isfinite(rtf) or rtf <= 0:
        raise RuntimeError(f"bad measurement {rep}")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"metric": f"streaming_rtf_{STREAMS}", "value": rtf,
                      "unit": "xRT", "vs_baseline": TARGET_RTF / rtf}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
