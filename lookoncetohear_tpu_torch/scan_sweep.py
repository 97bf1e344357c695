"""The training scan kernels at every tile size, on one GPU.

    python3 -m lookoncetohear_tpu_torch.scan_sweep [--h128] [--out FILE]

For each shape (T, D, N) of the committed training configs' scans (TSE
intra [97, 2, 5000] and inter [625, 1, 776] from a carried state,
EmbedNet intra [62, 2, 10008] and inter [1248, 2, 520]) and the
inference paths' one-direction scans (the full forward's [625, 1, 97],
the eval's [625, 1, 388]): what each tile of R rows compiled to
(threads, dynamic shared memory, registers, spilled bytes, resident
blocks per SM), then the forward (`bilstm_train_fwd_f32`) and the
backward (`bilstm_train_bwd_f32`) launched through their C entries at
each R, the median device time of REPS launches by CUDA events, each
output's largest difference from the plain version, and the kernels for
which the wrapper picks that R (`ops/bilstm_scan.py::tile_rows`).
Then the H = 128 kernels (`csrc/bilstm_scan.cu`, tiles of R rows over
clusters of C CTAs, the product on the tensor cores) at the reference's
default `Net`'s scans (B2 at its 64-stream step [141, 2, 64], the full
forward's [141, 2, 500] and the eval's batch of 4 [141, 2, 2000]; the
training forward at the full forward's inter-time scan (500, 1, 141),
the eval's (500, 1, 564) and the training step's at 8 x 5 s, (141, 2,
4000) and (500, 1, 1128), from a carried state where D = 1, without cs,
and at the two training scans also with cs and the gates, as a step
that keeps its gradient runs it; the backward at those two training
scans, from the gates and cs of one forward): each tile's build and the
clusters the card holds at once, its median device time, its largest
difference from the plain version, and whether `tile_h128` picks it
(`--h128`: only these).
Random inputs made on the card from a seed. Prints one JSON object per
measurement, each with the card's name and power limit, and writes them
to --out if given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from lookoncetohear_tpu_torch import _build
from lookoncetohear_tpu_torch.ops.bilstm_scan import (
    TRAIN_TILE_COST, bilstm_scan_reference, bilstm_train_backward_reference,
    bilstm_train_gates_backward_reference, bilstm_train_reference,
    h128_tiles, tile_h128, tile_rows)
from lookoncetohear_tpu_torch.timing import device_ms

SHAPES = {"tse_intra": (97, 2, 5000), "tse_inter": (625, 1, 776),
          "embed_intra": (62, 2, 10008), "embed_inter": (1248, 2, 520),
          "full_forward_inter": (625, 1, 97), "eval_inter": (625, 1, 388)}
# the H = 128 kernels' shapes: B2 [T, 2, B]; the training forward and
# the backward (T, D, N) from a carried state where D = 1
H128_SHAPES = {"b2_serving": (141, 2, 64), "b2_full_forward": (141, 2, 500),
               "b2_eval": (141, 2, 2000),
               "fwd_full_forward_inter": (500, 1, 141),
               "fwd_eval_inter": (500, 1, 564),
               "fwd_train_intra": (141, 2, 4000),
               "fwd_train_inter": (500, 1, 1128),
               "fwdg_train_intra": (141, 2, 4000),
               "fwdg_train_inter": (500, 1, 1128),
               "bwd_train_intra": (141, 2, 4000),
               "bwd_train_inter": (500, 1, 1128)}
REPS = 10  # timed launches of each kernel at each tile and shape
INFO = ("threads", "smem_bytes", "registers", "spill_bytes", "blocks_per_sm")
INFO_H128 = ("threads", "smem_bytes", "registers", "spill_bytes",
             "clusters_held", "ctas_per_sm")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h128", action="store_true",
                    help="only the H = 128 kernels")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    lib = _build.load_library()
    rows = []

    def emit(**kw):
        kw["device"] = smi
        rows.append(kw)
        print(json.dumps(kw), flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    if not args.h128:
        sweep_train(lib, emit, dev, g, stream)
    sweep_h128(lib, emit, dev, g, stream)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


def sweep_train(lib, emit, dev, g, stream):
    """The H = 64 training kernels at every tile and SHAPES."""
    tiles = sorted({r for c in TRAIN_TILE_COST.values() for r in c})
    for r in tiles:
        for bwd in (0, 1):
            out = (ctypes.c_int * 5)()
            _build.check(lib.bilstm_train_info(r, bwd, out), "info")
            emit(kernel="bilstm_train_bwd" if bwd else "bilstm_train_fwd",
                 rows=r, **dict(zip(INFO, out)))
    for key, (t_, nd, n) in SHAPES.items():
        def r_(*shape, k=0.5):
            return torch.randn(shape, generator=g, device=dev) * k
        xp, w = r_(n, t_, nd * 256), r_(nd, 64, 256, k=0.3)
        h0, c0 = (r_(nd, n, 64), r_(nd, n, 64)) if nd == 1 else (None, None)
        dy, dct = r_(n, t_, nd * 64, k=1.0), r_(nd, n, 64, k=1.0)
        p = (lambda t: None if t is None else t.data_ptr())
        y, cs = torch.empty(n, t_, nd * 64, device=dev), \
            torch.empty(n, t_, nd * 64, device=dev)
        c_t, dh0, dc0 = (torch.empty(nd, n, 64, device=dev)
                         for _ in range(3))
        dxp = torch.empty_like(xp)
        want_f = bilstm_train_reference(xp, w, torch.float32, h0, c0,
                                        with_cs=True)
        want_b = bilstm_train_backward_reference(xp, w, h0, c0, *want_f[::2],
                                                 dy, dct)

        def fwd(r, i):
            _build.check(lib.bilstm_train_fwd_f32(
                p(xp), p(w), p(h0), p(c0), p(y), p(cs), p(c_t), t_, nd, n, 64,
                r, stream), "bilstm_train_fwd_f32")

        def bwd(r, i):
            _build.check(lib.bilstm_train_bwd_f32(
                p(xp), p(w), p(h0), p(c0), p(want_f[0]), p(want_f[2]), p(dy),
                p(dct), p(dxp), p(dh0), p(dc0), t_, nd, n, 64, r, stream),
                "bilstm_train_bwd_f32")
        for r in tiles:
            fwd(r, 0)
            bwd(r, 0)
            torch.cuda.synchronize()
            err_f = max((a - b).abs().max().item()
                        for a, b in zip((y, c_t, cs), want_f))
            err_b = max((a - b).abs().max().item()
                        for a, b in zip((dxp, dh0, dc0), want_b))
            us_f = device_ms(lambda i: fwd(r, i), REPS) * 1e3
            us_b = device_ms(lambda i: bwd(r, i), REPS) * 1e3
            emit(shape=key, T=t_, D=nd, N=n, rows=r, fwd_us=us_f,
                 bwd_us=us_b, fwd_max_abs_err=err_f, bwd_max_abs_err=err_b,
                 picked=[k for k in TRAIN_TILE_COST
                         if r == tile_rows(n, nd, dev, k)])
        del xp, w, dy, dxp, y, cs, want_f, want_b
        torch.cuda.empty_cache()


def sweep_h128(lib, emit, dev, g, stream):
    """The H = 128 kernels at every tile (R, C) and H128_SHAPES."""
    kernels = ("b2", "fwd", "bwd")
    for kernel in kernels:
        for tile in h128_tiles(kernel):
            out = (ctypes.c_int * 6)()
            _build.check(lib.bilstm_h128_info(*tile, kernels.index(kernel),
                                              out), "bilstm_h128_info")
            emit(kernel=f"bilstm_h128_{kernel}", tile=list(tile),
                 **dict(zip(INFO_H128, out)))
    for key, (t_, nd, n) in H128_SHAPES.items():
        kernel = key.split("_")[0]
        # "fwdg": the training forward saving cs and the gates
        saving = kernel in ("fwdg", "bwd")
        kernel = "fwd" if kernel == "fwdg" else kernel

        def r_(*shape, k=0.5):
            return torch.randn(shape, generator=g, device=dev) * k
        p = (lambda t: None if t is None else t.data_ptr())
        if kernel == "b2":
            xp, w = r_(t_, 2, n, 512), r_(2, 128, 512, k=0.2)
            want = bilstm_scan_reference(xp, w)
            got = tuple(torch.empty_like(e) for e in want)

            def run(tile, i):
                _build.check(lib.bilstm_scan_h128_f32(
                    p(xp), p(w), p(got[0]), p(got[1]), t_, n, *tile,
                    stream), "bilstm_scan_h128_f32")
        else:
            xp, w = r_(n, t_, nd * 512), r_(nd, 128, 512, k=0.2)
            h0, c0 = (r_(nd, n, 128), r_(nd, n, 128)) if nd == 1 \
                else (None, None)
            want = bilstm_train_reference(xp, w, torch.float32, h0, c0,
                                          with_cs=saving, with_gates=saving)
            if kernel == "bwd":
                cs, gates = want[2:]
                dy, dct = r_(n, t_, nd * 128, k=1.0), r_(nd, n, 128, k=1.0)
                want = bilstm_train_gates_backward_reference(gates, w, c0, cs,
                                                             dy, dct)
            got = tuple(torch.empty_like(e) for e in want)

            def run(tile, i):
                if kernel == "fwd":
                    _build.check(lib.bilstm_train_fwd_h128_f32(
                        p(xp), p(w), p(h0), p(c0), p(got[0]),
                        p(got[2]) if saving else None,
                        p(got[3]) if saving else None, p(got[1]), t_, nd, n,
                        *tile, stream), "bilstm_train_fwd_h128_f32")
                else:
                    _build.check(lib.bilstm_train_bwd_h128_f32(
                        p(gates), p(w), p(c0), p(cs), p(dy), p(dct),
                        *map(p, got), t_, nd, n, *tile, stream),
                        "bilstm_train_bwd_h128_f32")
        for tile in h128_tiles(kernel):
            run(tile, 0)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            emit(shape=key, T=t_, D=nd, N=n, tile=list(tile),
                 us=device_ms(lambda i: run(tile, i), REPS) * 1e3,
                 max_abs_err=err,
                 picked=tile == tile_h128(n, nd, dev, kernel))
        del xp, w, want, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
