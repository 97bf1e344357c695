"""Where a step of the H = 128 scan kernels' time goes (B2, the
training forward and its backward at H = 128, csrc/bilstm_scan.cu),
phase by phase, on one GPU.

    python3 -m lookoncetohear_tpu_torch.scan_phases [--baseline DIR]
        [--calls N] [--shape NAME=T,D,N ...] [--tile R,C] [--out FILE]

Makes an instrumented copy of this tree's `csrc/bilstm_scan.cu` (and of
DIR's, for example the parent commit's tree unpacked with `git archive`)
under the build directory, which git ignores, and builds each with one
`nvcc`. Thread 0 of every CTA reads `%clock` at the phase boundaries
of every step that `_PROBES` names for the kernel's design and adds
each phase's cycles up over the scan (32-bit counters, few registers);
it also reads `%globaltimer` and `%clock64` once before the first step
and once after the last. A
phase's time a step is its cycles over the scan, times the CTA's
nanoseconds per cycle (the two timers' spans), over T: the global timer
alone ticks too coarsely for phases of tens of nanoseconds.

Each version's entries run at the default `Net`'s scan shapes (B2 at
the 64-stream step's [141, 2, 64, 512] and the full forward's [141, 2,
500, 512]; the training forward at the full forward's inter-time scan,
T=500, D=1, N=141, from a carried state, no cs; the backward at the
training step's scans (141, 2, 4000) and (500, 1, 1128)), at the tile
its own wrapper picks, on inputs made on the card from a seed. Each
version is called through the C signatures its source declares: the
backward that recomputes the gates takes xp and y, the one that reads
them the forward's gates; both get the outputs of one forward.
Prints one JSON object per kernel, shape and version: the median over
CTAs of each phase's µs a step (median over --calls calls), the median
CTA's µs a step between its first and last stamp, the launch's span by
CUDA events over T, the tile, and the card's name and power limit.

Phases of PR 14's 2-CTA design ("pair"): the wait on the peer's half of
h (its mbarrier); the h loads and the FMA product; the octet's
reduce-scatter; the gate math (nonlinearities, the gather of a row's
gates, c and h); the stores and the hand-over (own h, `st.async` to the
peer, y and cs, the next xp); the block barrier. Of the tensor-core
design ("mma"): the wait on the step's h (its mbarrier, after the read
of the step's xp from the ring); the h loads and
their TF32 split; the three-product MMAs; the reduction of the four
K-quarters through shared memory (with its named barrier); the gate
math; the stores and the hand-over (h into every CTA of the cluster, y
and cs, the prefetch of xp). Of the backward that recomputes the gates
("bwd_recompute"): the prefetch, the wait on the cluster's
partials of the step and the sum of the 8 slots; dgates (and their
stores to dxp and shared memory); the block barrier; the dh MMAs; the
sends (the reduce-scatter); the recompute's MMAs (the gates of the step
before, from y); their reduction over the four K-quarters (with its
named barrier); the recompute's gate math. Of the backward that reads
the gates ("bwd_gates"): the prefetch and the ring's read with
what does not depend on dh (tanh(c) and the factors of dgates); the
wait on the cluster's partials and the sum of the 8 slots; dgates and
their stores; the block barrier; the dh MMAs (with the dgates' loads and
TF32 split); the sends. The stamps are by thread 0 of each CTA, a cell
thread of warp 0, which also sends warp 0's partials. The stamps add a
few instructions a phase; the copies are not the kernels the port runs.
`--shape` runs other shapes instead (NAME starting with "b2", "fwd" or
"bwd"); `--tile` runs this tree's copy at that tile instead of its
wrapper's.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from lookoncetohear_tpu_torch import _build

# kernel -> shape: B2 [T, 2, B]; the training forward and the backward
# (T, D, N)
SHAPES = {"b2_serving": (141, 2, 64), "b2_full_forward": (141, 2, 500),
          "fwd_full_forward_inter": (500, 1, 141),
          "bwd_train_intra": (141, 2, 4000),
          "bwd_train_inter": (500, 1, 1128)}
_SLOTS = 13            # per CTA: 8 phase sums, the timers, the entry

_PRELUDE = r"""
__device__ unsigned long long g_scan_stamps[1 << 18];
__device__ __forceinline__ unsigned long long sp_clk() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned sp_clk32() {
  unsigned t;
  asm volatile("mov.u32 %0, %%clock;" : "=r"(t));
  return t;
}
__device__ __forceinline__ unsigned long long sp_gt() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define SP_START if (threadIdx.x == 0) sp_t = sp_clk32();
#define SP_MARK(i) if (threadIdx.x == 0) { \
    const unsigned n_ = sp_clk32(); sp_[i] += n_ - sp_t; sp_t = n_; }
"""
_GETTER = r"""
extern "C" int scan_phase_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_scan_stamps, (size_t)n * 8);
}
"""
_BEGIN = ("unsigned sp_[8] = {0, 0, 0, 0, 0, 0, 0, 0}, sp_t = 0;\n  "
          "unsigned long long sp_g0 = 0, sp_c0 = 0;\n  if (threadIdx.x == "
          "0) { sp_g0 = sp_gt(); sp_c0 = sp_clk(); }\n")
_ENTRY = "  const unsigned long long sp_e0 = sp_gt();\n"
_END = ("  if (threadIdx.x == 0) {\n    unsigned long long* st_ = "
        "g_scan_stamps + 13 * (blockIdx.x + gridDim.x * blockIdx.y);\n"
        "    for (int i_ = 0; i_ < 8; ++i_) st_[i_] = sp_[i_];\n"
        "    st_[8] = sp_g0; st_[9] = sp_gt(); st_[10] = sp_c0; "
        "st_[11] = sp_clk(); st_[12] = sp_e0;\n  }\n")

# design -> (phase names, exact (text, instrumented text) replacements in
# the H = 128 part of the source; each text must occur there exactly once).
# A source gets the first forward design ("pair", "mma") whose texts all
# match and the first backward design ("bwd_*") that does, if any.
_PROBES = {
    "pair": (
        ["wait on the peer's half", "h loads + product", "reduction",
         "gate math", "stores + hand-over", "block barrier"],
        [("  constexpr int VPL = R / 2;",
          _ENTRY + "  constexpr int VPL = R / 2;"),
         ("  cluster.sync();\n", "  cluster.sync();\n  " + _BEGIN),
         ("    if (s > 0) {\n      // the peer's half",
          "    SP_START\n    if (s > 0) {\n      // the peer's half"),
         ("    float acc[R * 4];\n",
          "    SP_MARK(0)\n    float acc[R * 4];\n"),
         ("    // acc[4 r + g] summed over the octet",
          "    SP_MARK(1)\n    // acc[4 r + g] summed over the octet"),
         ("    float act[VPL];\n", "    SP_MARK(2)\n    float act[VPL];\n"),
         ("    // this step's h into the next buffer of both CTAs",
          "    SP_MARK(3)\n    // this step's h into the next buffer of both"
          " CTAs"),
         ("    // this step's own half visible, every read of the other "
          "buffer done\n    __syncthreads();\n",
          "    SP_MARK(4)\n    __syncthreads();\n    SP_MARK(5)\n"),
         ("  if (role == 0 && live) c_out[", _END + "  if (role == 0 && live)"
          " c_out[")]),
    "mma": (
        ["wait on the step's h", "h loads + TF32 split", "three-product MMA",
         "K reduction", "gate math", "stores + hand-over"],
        [("  using TL = Tile<R, C>;\n",
          _ENTRY + "  using TL = Tile<R, C>;\n"),
         ("  // ---- the scan\n", _BEGIN + "  // ---- the scan\n"),
         ("  for (int s = 0; s < T; ++s) {\n",
          "  for (int s = 0; s < T; ++s) {\n    SP_START\n"),
         ("    // ---- h loads\n", "    SP_MARK(0)\n    // ---- h loads\n"),
         ("    // ---- product\n", "    SP_MARK(1)\n    // ---- product\n"),
         ("    // ---- reduction\n",
          "    SP_MARK(2)\n    // ---- reduction\n"),
         ("    // ---- gate math\n",
          "    SP_MARK(3)\n    // ---- gate math\n"),
         ("    // ---- hand-over\n",
          "    SP_MARK(4)\n    // ---- hand-over\n"),
         ("    // ---- step end\n",
          "    SP_MARK(5)\n    // ---- step end\n"),
         ("  // ---- the end\n", _END + "  // ---- the end\n")]),
    "bwd_recompute": (
        ["prefetch + wait + 8-slot sum", "dgates", "block barrier",
         "dh MMAs", "sends", "recompute MMAs", "recompute reduction",
         "recompute gates"],
        [("  using TL = BwdTile<R>;\n", _ENTRY + "  using TL = BwdTile<R>;\n"),
         ("  // ---- the scan, s = T..0: step T only forms the gates of step "
          "T-1\n", _BEGIN + "  // ---- the scan, s = T..0\n"),
         ("  for (int s = T; s >= 0; --s) {\n",
          "  for (int s = T; s >= 0; --s) {\n    SP_START\n"),
         ("      const float2 av = a_own[(s % kXD) * P * CELLS];   // "
          "(c_prev, dy)\n", "      SP_MARK(0)\n      const float2 av = "
          "a_own[(s % kXD) * P * CELLS];\n"),
         ("    // this thread's copies of step s-1 have landed; after the "
          "barrier\n", "    SP_MARK(1)\n"),
         ("    // ---- dh product\n", "    SP_MARK(2)\n"),
         ("      // ---- reduce-scatter\n", "      SP_MARK(3)\n"),
         ("    // ---- gates of step s-1, from h_{s-2} (off the chain)\n",
          "    SP_MARK(4)\n"),
         ("#pragma unroll\n      for (int nt = 0; nt < NT; ++nt)\n#pragma "
          "unroll\n        for (int e = 0; e < 2; ++e)\n          red_s[",
          "      SP_MARK(5)\n#pragma unroll\n      for (int nt = 0; nt < NT; "
          "++nt)\n#pragma unroll\n        for (int e = 0; e < 2; ++e)\n"
          "          red_s["),
         ("        const float4 xv = x_own[sl * P * CELLS];\n",
          "        SP_MARK(6)\n        const float4 xv = x_own[sl * P * "
          "CELLS];\n"),
         ("        go = sigmoid_rn(a.w + xv.w);\n      }\n",
          "        go = sigmoid_rn(a.w + xv.w);\n      }\n      SP_MARK(7)\n"),
         ("  // ---- the end: dh0 from the cluster's partials of step 0\n",
          _END + "  // ---- the end\n")]),
    "bwd_gates": (
        ["prefetch + ring read + factors", "wait + 8-slot sum", "dgates",
         "block barrier", "dh MMAs", "sends"],
        [("  using TL = BwdTile<R>;\n", _ENTRY + "  using TL = BwdTile<R>;\n"),
         ("  // ---- the scan, s = T-1..0\n",
          _BEGIN + "  // ---- the scan, s = T-1..0\n"),
         ("  for (int s = T - 1; s >= 0; --s) {\n",
          "  for (int s = T - 1; s >= 0; --s) {\n    SP_START\n"),
         ("      // ---- wait\n", "      SP_MARK(0)\n"),
         ("      // ---- dgates\n", "      SP_MARK(1)\n"),
         ("    // ---- block barrier\n", "    SP_MARK(2)\n"),
         ("    // ---- dh product\n", "    SP_MARK(3)\n"),
         ("    // ---- reduce-scatter\n", "    SP_MARK(4)\n"),
         ("    // ---- end of the step\n", "    SP_MARK(5)\n"),
         ("  // ---- the end: dh0 from the cluster's partials of step 0\n",
          _END + "  // ---- the end\n")]),
}


def instrument(src: str) -> tuple[dict, str]:
    """({"fwd": design, "bwd": design or None}, instrumented source) of a
    version of bilstm_scan.cu; only the H = 128 part (from `namespace
    h128`) is probed."""
    head, sep, tail = src.partition("namespace h128 {")
    if not sep:
        raise RuntimeError("bilstm_scan.cu has no H = 128 kernels")
    designs = {"fwd": None, "bwd": None}
    for design, (_, probes) in _PROBES.items():
        kind = "bwd" if design.startswith("bwd") else "fwd"
        if designs[kind] is None and all(tail.count(a) == 1
                                         for a, _ in probes):
            for text, new in probes:
                tail = tail.replace(text, new)
            designs[kind] = design
    if designs["fwd"] is None:
        raise RuntimeError("no probe set matches this bilstm_scan.cu")
    inc = "#include <cuda_runtime.h>\n"
    return designs, (head.replace(inc, inc + _PRELUDE, 1) + sep + tail
                     + _GETTER)


def cost_table(tree: Path, name: str = "H128_TILE_COST") -> dict:
    """A tile cost table (H128_TILE_COST, H128_BWD_TILE_COST) as the
    tree's own wrapper declares it."""
    text = (tree / "lookoncetohear_tpu_torch" / "ops" /
            "bilstm_scan.py").read_text()
    m = re.search(rf"^{name} = (\{{.*?\}})", text, re.S | re.M)
    return ast.literal_eval(m.group(1))


def _pointers(src: str, entry: str) -> int:
    """The tensor pointer parameters of the C entry `entry` in a version
    of bilstm_scan.cu, its stream aside (0 if it has none)."""
    m = re.search(rf"int {entry}\(([^)]*)\)", src)
    return 0 if m is None else m.group(1).count("void*") - 1


def signatures(src: str) -> dict:
    """What a version's H = 128 C entries take: {"fwd": pointer
    parameters of the training forward (7: no gates output, 8: the
    gates), "bwd": "recompute" (xp and y), "gates" (the forward's
    gates) or None (no backward)}."""
    bwd = _pointers(src, "bilstm_train_bwd_h128_f32")
    return {"fwd": _pointers(src, "bilstm_train_fwd_h128_f32"),
            "bwd": {0: None, 11: "recompute", 9: "gates"}[bwd]}


def fwd_args(sig, xp, w, h0, c0, y, cs, gates, c_t):
    """The pointer arguments of a version's training forward entry."""
    p = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    return [p(v) for v in (xp, w, h0, c0, y, cs) + (
        (gates,) if sig["fwd"] == 8 else ()) + (c_t,)]


def bwd_args(sig, xp, w, h0, c0, y, cs, gates, dy, dc_t, dxp, dh0, dc0):
    """The pointer arguments of a version's backward entry, from one
    forward's outputs."""
    p = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    ins = (xp, w, h0, c0, y, cs, dy, dc_t) if sig["bwd"] == "recompute" \
        else (gates, w, c0, cs, dy, dc_t)
    return [p(v) for v in ins + (dxp, dh0, dc0)]


def design_of(src: str) -> str:
    """The H = 128 design of a version of bilstm_scan.cu, by the tile its
    B2 entry takes: "mma" (R and C) or "pair" (R alone)."""
    m = re.search(r"int bilstm_scan_h128_f32\(([^)]*)\)", src)
    if m is None:
        raise RuntimeError("bilstm_scan.cu has no bilstm_scan_h128_f32")
    return "mma" if "int C" in m.group(1) else "pair"


def h128_tile(design, lib, cost, n, nd, train):
    """The tile that the version's wrapper picks: (R,) for "pair", (R, C)
    for "mma"; the clusters each tile's kernel holds come from the
    version's own info entry (`train`: 0 B2, 1 the training forward, 2
    the backward, with the backward's cost table)."""
    def held(key):
        out = (ctypes.c_int * 6)()
        _build.check(lib.bilstm_h128_info(*key, int(train), out), "info")
        return max(1, out[4])
    if design == "pair":
        def time(r):
            return -(-nd * -(-n // r) // held((r,))) * cost[r]
        return (min(sorted(cost), key=time),)

    def time_rc(key):
        r, c = key
        return -(-nd * -(-n // r) // held(key)) * cost[key]
    return min(sorted(cost), key=time_rc)


def bind_h128(lib, design, sig=None):
    """ctypes signatures of a version's H = 128 entries, as its source
    declares them (`sig` from `signatures`; None: a forward of 7
    pointers and no backward)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    sig = sig or {"fwd": 7, "bwd": None}
    k = 1 if design == "pair" else 2       # R, or R and C
    lib.bilstm_scan_h128_f32.argtypes = [P] * 4 + [I] * (2 + k) + [P]
    lib.bilstm_train_fwd_h128_f32.argtypes = [P] * sig["fwd"] + \
        [I] * (3 + k) + [P]
    lib.bilstm_h128_info.argtypes = [I] * (k + 1) + [P]
    names = ["bilstm_scan_h128_f32", "bilstm_train_fwd_h128_f32",
             "bilstm_h128_info"]
    if sig["bwd"]:
        lib.bilstm_train_bwd_h128_f32.argtypes = [P] * (
            11 if sig["bwd"] == "recompute" else 9) + [I] * 5 + [P]
        names.append("bilstm_train_bwd_h128_f32")
    for f in names:
        getattr(lib, f).restype = I


def phases(names, st: np.ndarray, steps: int) -> dict:
    """µs a step of each phase, the median over CTAs, from the stamps
    [CTAs, _SLOTS]."""
    st = st.astype(np.float64)
    ns_per_clk = (st[:, 9] - st[:, 8]) / np.maximum(st[:, 11] - st[:, 10], 1)
    row = {name: float(np.median(st[:, i] * ns_per_clk)) / steps / 1e3
           for i, name in enumerate(names)}
    row["CTA µs a step"] = float(np.median(st[:, 9] - st[:, 8])) / steps / 1e3
    row["ns per cycle"] = float(np.median(ns_per_clk))
    # before the first step (W_hh's fragments, the initial state, the
    # cluster's start), and the spread of the CTAs' starts and ends
    row["prologue µs"] = float(np.median(st[:, 8] - st[:, 12])) / 1e3
    row["start spread µs"] = float(st[:, 12].max() - st[:, 12].min()) / 1e3
    row["end spread µs"] = float(st[:, 9].max() - st[:, 9].min()) / 1e3
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--shape", action="append", default=[],
                    help="NAME=T,D,N in place of the path shapes")
    ap.add_argument("--tile", help="R,C for this tree's copy")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device", file=sys.stderr)
        return 1
    trees = {"this": _build.CSRC.parent.parent}
    if args.baseline:
        trees["baseline"] = args.baseline.resolve()
    work = _build.BUILD_DIR
    work.mkdir(parents=True, exist_ok=True)
    builds = {}
    for version, tree in trees.items():
        source = (tree / "lookoncetohear_tpu_torch" / "csrc" /
                  "bilstm_scan.cu").read_text()
        designs, text = instrument(source)
        src = work / f"scan_phases_{version}.cu"
        src.write_text(text)
        lib = work / f"scan_phases_{version}.so"
        builds[version] = (designs, signatures(source), tree, lib,
                           subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for version, (designs, sig, tree, lib, proc) in builds.items():
        log, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        cdll = ctypes.CDLL(str(lib))
        bind_h128(cdll, designs["fwd"], sig)
        cdll.scan_phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        costs = {"fwd": cost_table(tree)}
        if designs["bwd"]:
            costs["bwd"] = cost_table(tree, "H128_BWD_TILE_COST")
        libs[version] = (designs, sig, cdll, costs)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    shapes = SHAPES
    if args.shape:
        shapes = {k: tuple(int(v) for v in s.split(","))
                  for k, s in (a.split("=") for a in args.shape)}
    for key, (t_, nd, n) in shapes.items():
        kind = key.split("_")[0]
        train = kind != "b2"

        def r_(*shape, k=0.5):
            return torch.randn(shape, generator=g, device=dev) * k
        if train:
            xp, w = r_(n, t_, nd * 512), r_(nd, 128, 512, k=0.2)
            h0, c0 = r_(nd, n, 128), r_(nd, n, 128)
            y, c_t = torch.empty(n, t_, nd * 128, device=dev), \
                torch.empty(nd, n, 128, device=dev)
        else:
            xp, w = r_(t_, 2, n, 512), r_(2, 128, 512, k=0.2)
            y, c_t = torch.empty(t_, 2, n, 128, device=dev), \
                torch.empty(2, n, 128, device=dev)
        if kind == "bwd":
            # one forward's y, cs and gates for every version's backward
            cs, gates = torch.empty_like(y), torch.empty_like(xp)
            this_sig = libs["this"][1]
            _build.check(libs["this"][2].bilstm_train_fwd_h128_f32(
                *fwd_args(this_sig, xp, w, h0, c0, y, cs, gates, c_t),
                t_, nd, n, *h128_tile("mma", libs["this"][2],
                                      libs["this"][3]["fwd"], n, nd, 1),
                stream), "training forward")
            dy, dct = r_(n, t_, nd * 128, k=1.0), r_(nd, n, 128, k=1.0)
            dxp, dh0, dc0 = (torch.empty_like(xp), torch.empty_like(c_t),
                             torch.empty_like(c_t))
        for version, (designs, sig, cdll, costs) in libs.items():
            if kind == "bwd" and not designs["bwd"]:
                continue
            design = designs["bwd" if kind == "bwd" else "fwd"]
            tile = h128_tile(designs["fwd"], cdll, costs[
                "bwd" if kind == "bwd" else "fwd"], n, nd,
                ("b2", "fwd", "bwd").index(kind))
            if args.tile and version == "this":
                tile = tuple(int(v) for v in args.tile.split(","))
            if kind == "bwd":
                def run():
                    _build.check(cdll.bilstm_train_bwd_h128_f32(
                        *bwd_args(sig, xp, w, h0, c0, y, cs, gates, dy, dct,
                                  dxp, dh0, dc0), t_, nd, n, *tile, stream),
                        "backward")
            elif train:
                def run():
                    _build.check(cdll.bilstm_train_fwd_h128_f32(
                        *fwd_args(sig, xp, w, h0, c0, y, None, None, c_t),
                        t_, nd, n, *tile, stream), "training forward")
            else:
                def run():
                    _build.check(cdll.bilstm_scan_h128_f32(
                        xp.data_ptr(), w.data_ptr(), y.data_ptr(),
                        c_t.data_ptr(), t_, n, *tile, stream), "B2")
            r = tile[0]
            ctas = nd * -(-n // r) * (2 if design == "pair" else tile[1])
            if ctas * _SLOTS > 1 << 18:
                raise RuntimeError(f"{key}: {ctas} CTAs, more than the "
                                   f"stamps hold")
            host = np.zeros(ctas * _SLOTS, dtype=np.uint64)
            names = _PROBES[design][0]
            calls, spans = [], []
            for i in range(args.calls + 2):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                run()
                end.record()
                torch.cuda.synchronize()
                _build.check(cdll.scan_phase_stamps(host.ctypes.data,
                                                    ctas * _SLOTS), "stamps")
                if i >= 2:
                    calls.append(phases(names, host.reshape(ctas, _SLOTS),
                                        t_))
                    spans.append(start.elapsed_time(end) * 1e3)
            row = dict(shape=key, T=t_, D=nd, N=n, version=version,
                       design=design, tile=list(tile), calls=args.calls,
                       device=smi, **{k: float(np.median([c[k] for c in
                                                          calls]))
                                      for k in calls[0]})
            row["launch µs a step (events)"] = float(np.median(spans)) / t_
            results.append(row)
            print(json.dumps(row), flush=True)
        del xp, w, y, c_t
        if kind == "bwd":
            del cs, gates, dy, dct, dxp, dh0, dc0
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
