"""The ring attention kernel (B3/B4, csrc/attn_step.cu) at other tile
sizes and depths, and its copies without the arithmetic, on one GPU.

    python3 -m lookoncetohear_tpu_torch.attn_sweep [--baseline DIR]
        [--grid 16x3,24x2,...] [--out FILE]

Builds copies of this tree's `csrc/attn_step.cu` under the build
directory, which git ignores: one per --grid cell `KBxN`, with
kTileBytes = KB * 1024 and kMaxStages = N (a block keeps N - 1 tiles
outstanding), and "copies only": the tree's kernel with the same
copies, waits and barriers but without the scores and the weighted sum
(its output is not the function; it shows what the streaming alone
takes). --baseline DIR adds that tree's kernel (for example the parent
commit's, unpacked with `git archive`). Every version runs every entry
at the float ring's serving shape (256 head-major rows x 49 slots, Dk
582, Dv 1552) on three input sets made on the card, the versions in
turn and then in reverse; prints one JSON object per entry with each
version's mean µs by CUDA events and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from lookoncetohear_tpu_torch import _build
from lookoncetohear_tpu_torch.ops.attn_step import VARIANTS
from lookoncetohear_tpu_torch.timing import attn_entry, attn_inputs, device_ms

ATTN = dict(rows=256, w1=49, dk=97 * 6, dv=97 * 16)
# the arithmetic that "copies only" skips: each text must occur once
_NO_MATH = [
    ("    if (Dk % 2 == 0)\n      score_tile<true, S>",
     "    if (Dk < 0)\n      score_tile<true, S>"),
    ("    else\n      score_tile<false, S>",
     "    else if (Dk < 0)\n      score_tile<false, S>"),
    ("    if (col0 < cols) {\n#pragma unroll 4",
     "    if (col0 < 0) {\n#pragma unroll 4"),
    ("    if (col1 < cols) {\n#pragma unroll 4",
     "    if (col1 < 0) {\n#pragma unroll 4"),
]


def variants(src: str, grid: list[str]) -> dict[str, str]:
    """{name: source} of the sweep's versions of attn_step.cu."""
    out = {}
    for cell in grid:
        kb, st = (int(x) for x in cell.split("x"))
        text, n1 = re.subn(r"constexpr int kTileBytes = [^;]*;",
                           f"constexpr int kTileBytes = {kb} * 1024;", src)
        text, n2 = re.subn(r"constexpr int kMaxStages = \d+;",
                           f"constexpr int kMaxStages = {st};", text)
        if n1 != 1 or n2 != 1:
            raise RuntimeError("kTileBytes / kMaxStages not found")
        out[f"{kb} KB x {st}"] = text
    text = src
    for old, new in _NO_MATH:
        if text.count(old) != 1:
            raise RuntimeError(f"copies only: {old!r} not found once")
        text = text.replace(old, new)
    out["copies only"] = text
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--grid", default="16x3,24x2,24x4,32x3")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_sweep: no CUDA device", file=sys.stderr)
        return 1
    src = (_build.CSRC / "attn_step.cu").read_text()
    versions = {"this": src}
    if args.baseline:
        versions["baseline"] = (args.baseline.resolve() / "lookoncetohear_"
                                "tpu_torch" / "csrc" / "attn_step.cu"
                                ).read_text()
    versions.update(variants(src, [c for c in args.grid.split(",") if c]))
    work = _build.BUILD_DIR
    work.mkdir(parents=True, exist_ok=True)
    builds = {}
    for i, (name, text) in enumerate(versions.items()):
        cu, so = work / f"attn_sweep_{i}.cu", work / f"attn_sweep_{i}.so"
        cu.write_text(text)
        builds[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in builds.items():
        log, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(so))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, w1, dk, dv = (ATTN[k] for k in ("rows", "w1", "dk", "dv"))
    results = []
    for (qdt, kvdt), entry in VARIANTS.items():
        sets = [attn_inputs(g, rows, w1, dk, dv, qdt, kvdt)
                for _ in range(3)]
        out = torch.empty((rows, dv), device=dev, dtype=qdt)
        fns = {name: attn_entry(lib, entry) for name, lib in libs.items()}
        us: dict = {}
        for name in list(fns) + list(fns)[::-1]:
            def call(i, fn=fns[name]):
                fn(sets[i % 3], out)
            for i in range(6):
                call(i)
            us.setdefault(name, []).append(device_ms(call, 150) * 1e3)
        row = dict(kernel=entry, device=smi,
                   **{k: float(np.mean(v)) for k, v in us.items()})
        results.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
