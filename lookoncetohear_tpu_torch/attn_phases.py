"""Where the ring attention kernel's time goes (B3/B4, csrc/attn_step.cu),
phase by phase, on one GPU.

    python3 -m lookoncetohear_tpu_torch.attn_phases [--baseline DIR]
        [--calls N] [--out FILE]

Makes an instrumented copy of this tree's `csrc/attn_step.cu` (and of
DIR's, for example the parent commit's tree unpacked with `git archive`)
under the build directory, which git ignores: `%globaltimer` stamps at
the phase boundaries that `_PROBES` names for each kernel design, read
by thread 0 of every block. Each copy is built alone and every entry is
run at the float ring's serving shape (256 head-major rows x 49 slots,
Dk 582, Dv 1552) on three input sets made on the card. Prints one JSON
object per entry and version: the median over blocks of each phase's
µs (median over --calls calls), the median block's µs from its start to
its end, the span from the first block's start to the last block's
end, and the spread of the blocks' starts and of their ends; each with
the card's name and power limit.

Phases of the two-pass kernel of PR 5 ("two-pass"): q staging; pass 1
(K loads and scores); the one-warp softmax; pass 2 (values). Of the
tiled kernel of PR 7 ("tiled"): the prologue (small loads, barriers,
first copies, q and v_t into shared memory, the current frame's
score); pass 1 split into the time spent waiting on K tiles and the
scores (with the next tile's copies and the barrier); the softmax; pass
2 split into waiting on V tiles and the values; the epilogue (output).
The stamps add a few instructions per tile; the copies are not the
kernels the port runs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from lookoncetohear_tpu_torch import _build
from lookoncetohear_tpu_torch.ops.attn_step import VARIANTS
from lookoncetohear_tpu_torch.timing import attn_entry, attn_inputs

ATTN = dict(rows=256, w1=49, dk=97 * 6, dv=97 * 16)
_SLOTS = 10                     # stamps per block

_PRELUDE = r"""
#include <stdint.h>
__device__ unsigned long long g_stamps[1 << 16];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""
_GETTER = r"""
extern "C" int attn_phase_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, (size_t)n * 8);
}
"""
_STORE = ("  __syncthreads();\n  if (threadIdx.x == 0) {{\n"
          "    unsigned long long* st_ = g_stamps + {n} * (blockIdx.x + "
          "gridDim.x * blockIdx.y);\n{body}  }}\n")
_T = "  const unsigned long long {0} = gtimer();\n"
_WAIT = "    bar_wait(&bar[s], (unsigned)(t / p.stages) & 1u);\n"

# exact (text, instrumented text) replacements per design; every text
# must occur exactly once in the source
_PROBES = {
    "two-pass": [
        ("  const int warp = tid >> 5;\n",
         "  const int warp = tid >> 5;\n" + _T.format("t0_")),
        ("  // ---- pass 1", _T.format("t1_") + "  // ---- pass 1"),
        ("  // ---- softmax", _T.format("t2_") + "  // ---- softmax"),
        ("  // ---- pass 2", _T.format("t3_") + "  // ---- pass 2"),
        ("      o[k] = from_f32<T>(fmaf(p_cur, to_f32(vtr[k]), acc[k]) / den);"
         "\n  }\n",
         "      o[k] = from_f32<T>(fmaf(p_cur, to_f32(vtr[k]), acc[k]) / den);"
         "\n  }\n" + _STORE.format(
             n=_SLOTS, body="    st_[0] = t0_; st_[1] = t1_; st_[2] = t2_; "
             "st_[3] = t3_; st_[4] = gtimer();\n")),
    ],
    "tiled": [
        ("  // the row's K span", _T.format("t0_") + "  // the row's K span"),
        ("  // ---- pass 1", _T.format("t1_") + "  unsigned long long tm_ = 0,"
         " tkw_ = 0, tks_ = 0, tvw_ = 0, tvv_ = 0;\n  // ---- pass 1"),
        ("& 15);\n" + _WAIT, "& 15);\n    tm_ = gtimer();\n" + _WAIT +
         "    tkw_ += gtimer() - tm_; tm_ = gtimer();\n"),
        ("inv, sc);\n    __syncthreads();\n  }\n",
         "inv, sc);\n    __syncthreads();\n    tks_ += gtimer() - tm_;\n  }\n"),
        ("  // ---- softmax", _T.format("t2_") + "  // ---- softmax"),
        ("  // ---- pass 2", _T.format("t3_") + "  // ---- pass 2"),
        ("    const float* w = sc + j0;\n" + _WAIT,
         "    const float* w = sc + j0;\n    tm_ = gtimer();\n" + _WAIT +
         "    tvw_ += gtimer() - tm_; tm_ = gtimer();\n"),
        ("col1);\n    }\n    __syncthreads();\n  }\n",
         "col1);\n    }\n    __syncthreads();\n    tvv_ += gtimer() - tm_;\n"
         "  }\n" + _T.format("t4_")),
        ("    store_f32(o + col1, r, kG);\n  }\n",
         "    store_f32(o + col1, r, kG);\n  }\n" + _STORE.format(
             n=_SLOTS, body="    st_[0] = t0_; st_[1] = t1_; st_[2] = tkw_; "
             "st_[3] = tks_; st_[4] = t2_; st_[5] = t3_; st_[6] = tvw_;\n"
             "    st_[7] = tvv_; st_[8] = t4_; st_[9] = gtimer();\n")),
    ],
}


def instrument(src: str) -> tuple[str, str]:
    """(design, instrumented source) of a version of attn_step.cu."""
    for design, probes in _PROBES.items():
        if all(src.count(a) == 1 for a, _ in probes):
            for text, new in probes:
                src = src.replace(text, new)
            head = "#include <stdint.h>\n"
            return design, src.replace(head, head + _PRELUDE, 1) + _GETTER
    raise RuntimeError("no probe set matches this attn_step.cu")


def phases(design: str, st: np.ndarray) -> dict:
    """µs of each phase per block, from the stamps [blocks, _SLOTS]."""
    us = lambda a: a.astype(np.float64) / 1e3   # noqa: E731
    if design == "two-pass":
        out = {"q staging": us(st[:, 1] - st[:, 0]),
               "pass 1: K loads + scores": us(st[:, 2] - st[:, 1]),
               "softmax": us(st[:, 3] - st[:, 2]),
               "pass 2: values": us(st[:, 4] - st[:, 3])}
        start, end = st[:, 0], st[:, 4]
    else:
        start, end = st[:, 0], st[:, 9]
        out = {"prologue": us(st[:, 1] - st[:, 0]),
               "pass 1: waiting on K": us(st[:, 2]),
               "pass 1: scores": us(st[:, 3]),
               "softmax": us(st[:, 5] - st[:, 4]),
               "pass 2: waiting on V": us(st[:, 6]),
               "pass 2: values": us(st[:, 7]),
               "epilogue": us(end - st[:, 8])}
    row = {k: float(np.median(v)) for k, v in out.items()}
    row["block"] = float(np.median(us(end - start)))
    row["span"] = float(us(end.max() - start.min()))
    row["start spread"] = float(us(start.max() - start.min()))
    row["end spread"] = float(us(end.max() - end.min()))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_phases: no CUDA device", file=sys.stderr)
        return 1
    trees = {"this": _build.CSRC.parent.parent}
    if args.baseline:
        trees["baseline"] = args.baseline.resolve()
    work = _build.BUILD_DIR
    work.mkdir(parents=True, exist_ok=True)
    builds = {}
    for version, tree in trees.items():
        design, text = instrument(
            (tree / "lookoncetohear_tpu_torch" / "csrc" / "attn_step.cu")
            .read_text())
        src = work / f"attn_phases_{version}.cu"
        src.write_text(text)
        lib = work / f"attn_phases_{version}.so"
        builds[version] = (design, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for version, (design, lib, proc) in builds.items():
        log, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        cdll = ctypes.CDLL(str(lib))
        cdll.attn_phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[version] = (design, cdll)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, w1, dk, dv = (ATTN[k] for k in ("rows", "w1", "dk", "dv"))
    results = []
    for (qdt, kvdt), name in VARIANTS.items():
        sets = [attn_inputs(g, rows, w1, dk, dv, qdt, kvdt)
                for _ in range(3)]
        out = torch.empty((rows, dv), device=dev, dtype=qdt)
        host = np.zeros(rows * _SLOTS, dtype=np.uint64)
        for version, (design, cdll) in libs.items():
            fn = attn_entry(cdll, name)
            calls = []
            for i in range(args.calls + 3):
                fn(sets[i % 3], out)
                torch.cuda.synchronize()
                _build.check(cdll.attn_phase_stamps(host.ctypes.data,
                                                    rows * _SLOTS), "stamps")
                if i >= 3:
                    calls.append(phases(design, host.reshape(rows, _SLOTS)))
            row = dict(kernel=name, version=version, design=design,
                       calls=args.calls, device=smi,
                       **{k: float(np.median([c[k] for c in calls]))
                          for k in calls[0]})
            results.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
